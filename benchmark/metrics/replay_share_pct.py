"""replay_share_pct (%, program_counter): of the built programs' runs in
the window (utils/jitcache.runs(): eager, capture, replay,
eager_multi_device), the share that replayed a captured CUDA graph."""


def read(ctx):
    runs = ctx.counters["runs"]
    total = sum(runs.values())
    if not total:
        return None
    return 100.0 * runs.get("replay", 0) / total
