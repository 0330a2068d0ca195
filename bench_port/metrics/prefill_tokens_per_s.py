"""Prompt tokens of every request whose first token reached the host in
the window, over the window."""


def read(run):
    if not run.requests:
        return None
    return sum(r["prompt_tokens"] for r in run.requests) / run.window_s
