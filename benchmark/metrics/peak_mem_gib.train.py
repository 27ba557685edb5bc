"""The most device memory the training window held allocated
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GiB."""


def read(view, facts):
    peak = facts.get("peak_bytes")
    return None if not peak else peak / 2 ** 30
