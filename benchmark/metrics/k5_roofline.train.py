"""K5 (``csrc/lstm_sequence.cu``, forward and backward chains with their
tile GEMMs): the bound of every tier's and layer's forward and backward at
the cell's batch and sequence, per traced step, over K5's traced device
time.  The traced steps are counted by the forward chain's launches, one
per tier and layer a step."""

from benchmark import flops, readers


def read(run):
    got = readers.kernels(run, "lstmseq_", "seq_gemm")
    fwd = readers.kernels(run, "lstmseq_fwd_chain")
    if got is None or fwd is None:
        return None
    m = run.model
    steps = fwd[1] / (len(m["frame_sizes"]) * m["n_rnn"])
    per = flops.k4_step_bound(m, run.counters["lanes"],
                              run.traffic["seq_len"])
    return 100.0 * per * steps / got[0]
