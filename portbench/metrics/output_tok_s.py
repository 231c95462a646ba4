"""Output tokens handed to the clients' streams in the window, over the
window's seconds."""


def read(run):
    return run.output_tokens_in_window() / run.seconds
