"""device_idle_pct: 100 - the share of the traced stretch in which an
operation ran on the card (the union of the device operations' intervals),
the mean over the cell's cards."""
from perfbench import trace


def read(run):
    p = run.profile
    if p is None or not p.ops:
        return None
    wall = (p.end_us - p.start_us) / 1e6
    busy = sum(trace.device_busy_s(p, d.index or 0) for d in p.devices) / len(p.devices)
    return 100.0 * (1.0 - busy / wall)
