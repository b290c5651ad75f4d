"""The training loop's own host work per step: ``Trainer.host_s`` over the
window (reading batches, staging them, launching steps, plugin hooks), per
step; its "sync" part, the host waiting for the card's NLLs, is left out."""


def read(run):
    c = run.counters
    if not c.get("steps"):
        return None
    work = sum(v for k, v in c["host_s"].items() if k != "sync")
    return 1e3 * work / c["steps"]
