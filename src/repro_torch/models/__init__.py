"""The LM stack of the port: the zamba2 hybrid (Mamba-2 layers and a shared
attention block) for inference, its building blocks and the model registry.
Parameters are the reference's tree of plain dicts, stacked layer axis
first."""
