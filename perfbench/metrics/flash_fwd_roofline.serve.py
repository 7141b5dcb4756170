"""The flash attention forward kernels' share of their roofline over the
profiled batches."""

from perfbench.harness.readers import roofline


def read(run):
    return roofline(run, "flash_attention", r"\bflash_fwd_(wg_|tc_)?kernel\b")
