"""The general generators: one per kind of job, each driven by a traffic
file's parameters (``traffic/<mix>.json`` names its ``driver``)."""
