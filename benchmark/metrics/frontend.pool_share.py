"""Host front-end (frontend/binding.py STATS): the share of the run's
pictures, warm-up and window, whose slice data ran ahead on the parse
pool of decode_stream's front-end, in %; the rest were parsed in order
(multi-slice, FMO, redundant or lost slices). Nothing on a program
without the pool."""

SOURCE = "program_counter"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    from h264bsd_tpu_torch.frontend import binding
    stats = getattr(binding, "STATS", None)
    if not stats:
        return None
    pooled = stats.get("pictures_pooled", 0)
    n = pooled + stats.get("pictures_serial", 0)
    return 100.0 * pooled / n if n else None
