"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the warm-up
and the window (reset before them; the plan and data already resident
count), in GiB."""


def read(ctx):
    if not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2 ** 30
