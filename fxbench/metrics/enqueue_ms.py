"""Host ms a frame takes to enqueue: the mean over every frame of the
untraced window of the benchmark's own clock around the entry's call
alone (the frame's inputs are made, and its colour read back, outside
it)."""


def read(t):
    if not t.enqueue_s:
        return None
    return sum(t.enqueue_s) / len(t.enqueue_s) * 1e3
