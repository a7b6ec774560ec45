"""The tied head's log-prob + entropy (``kernels/logprob``) against its
roofline, in %: the least time of every forward and backward call in the
traced steps (``counts.logprob_least_s``: the work any implementation
must do, at the bf16 peak or the HBM rate) over their device time.

A forward call is the forward kernel and its merge. A backward call is
every device operation launched inside the autograd node of the op's
backward: the cotangent kernel and the library products and copies that
finish dh and dw. The calls a step makes: one forward and one backward
per minibatch over its rows' positions, and for ``recompute`` one more
forward over the whole batch."""
import re
import sys

from perfbench import counts

FORWARD = re.compile(r"wg::walk<\d+, \(anonymous namespace\)::wg::Stats>"
                     r"|forward_merge|forward_partial")
BACKWARD_NODE = "_TokenLogprobEntropyBackward"


def read(run):
    tr = run.trace
    if tr is None or not run.traced_steps:
        return None
    fwd = [e for e in tr.device if FORWARD.search(e[2])]
    bwd = tr.launched_within(BACKWARD_NODE)
    heads = sum(1 for e in fwd if "walk" in e[2] or "partial" in e[2])
    m, t = run.model, run.traffic
    rows = t["prompts"] * t["group"]
    nmb = min(t["minibatches"], rows)
    pos = t["row_len"] - 1
    calls = [(rows // nmb * pos, True)] * nmb + [(rows // nmb * pos, False)] \
        * nmb
    if t["algo"] == "recompute":
        calls.append((rows * pos, False))
    want = len(run.traced_steps) * sum(1 for _, b in calls if not b)
    if heads != want or not bwd:
        print(f"logprob_roofline: {heads} forward kernels (want {want}), "
              f"{len(bwd)} backward operations: not read", file=sys.stderr)
        return None
    least = len(run.traced_steps) * sum(
        counts.logprob_least_s(T, m["d_model"], m["vocab_size"], b)
        for T, b in calls)
    device_s = sum(e[1] - e[0] for e in fwd + bwd) / 1e9
    return 100.0 * least / device_s
