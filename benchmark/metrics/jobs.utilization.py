"""``run_jobs``' lane utilization: requested samples over the lane-samples
the pool computed, over the window's manifests."""


def read(run):
    c = run.counters
    if not c.get("computed_samples"):
        return None
    return 100.0 * c["requested"] / c["computed_samples"]
