"""From process start to the first timed unit: loading, drawing the
weights and the warm-up of every shape the cell sends (host clock)."""


def read(run):
    return run["setup_s"]
