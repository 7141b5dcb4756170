"""Share of the profiled stretch in which no op ran on the device."""

from perfbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
