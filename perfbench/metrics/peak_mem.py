"""The card's peak of allocated memory over the window, in GB: the CUDA
caching allocator's peak (``torch.cuda.max_memory_allocated``), reset
at the window's start; nothing off the card."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["on_card"] else None
