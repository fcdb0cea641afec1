"""Set-up: from the process's start to the end of the warm-up (loading,
the kernels' build or load, inputs, weights, warm-up units), host clock."""


def read(raw):
    return raw["setup_s"]
