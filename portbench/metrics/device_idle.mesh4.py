"""device_idle.mesh4: each card's share of the profiled stretch's wall time in
which no operation ran on it (its device index in the trace), in percent,
averaged over the mesh's cards."""


def read(run):
    p = run.profile
    if p is None or not p.get("busy_by_card") or p["wall_s"] <= 0:
        return None
    busy, cards = p["busy_by_card"], p["cards"]
    return sum(1.0 - busy.get(i, 0.0) / p["wall_s"] for i in cards) / len(cards) * 100.0
