"""Prompt and generated tokens of every request answered in the window over
the window's whole time (host clock)."""


def read(run):
    if run.get("kind") != "serve":
        return None
    return run["window"]["tokens"] / run["window"]["seconds"]
