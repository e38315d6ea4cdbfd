"""The median over the window's jobs of the benchmark's own span around
``from_array`` and ``KMeans.fit`` (from a synchronised start to the fit's
return, the fit ending on its host read of the last shift), in s."""


def read(run):
    return run.window.get("kmeans_fit_s")
