"""Model: device time of matrix-multiply kernels in the traced window
over the tokens computed there (``layer.matmul_us_per_tok``), in us."""

from portbench import layer


def read(run):
    return layer.matmul_us_per_tok(run)
