"""The share of the GRU layers' recurrent products (``hg = h @ w_hh +
b_hh``) that ``megagen.run`` computed beside K1 (its span's ``offchain``
attr) among all of its calls' (``hg``), in the traced tail; None where no
``megagen.run`` span carries ``offchain`` (a port that keeps every
``hg`` on the chain) or the tail's calls have no GRU layer."""

from benchmark import program_spans


def read(run):
    runs = [s for s in program_spans.named(run, "megagen.run") or ()
            if "offchain" in s.attrs]
    total = sum(s.attrs["hg"] for s in runs)
    if not total:
        return None
    return 100.0 * sum(s.attrs["offchain"] for s in runs) / total
