"""Device time of work on the card, by CUDA events, and the least time
the card could take for it.

`graph_ms` is the measure of a kernel's device time: calls captured
back to back in one CUDA graph drop the host's launch cost, and the
caller hands each call its own input set (`rotations`), so that the sets
together outgrow the 50 MB L2 and every call reads device memory.
`bound` and `attention_bound` give the least time from the H100 SXM's
peak rates below; `nvidia_smi` names the card and its power limit, to be
kept beside every time.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

__all__ = ["events_ms", "graph_ms", "rotations", "bound", "attention_bound",
           "nvidia_smi"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores
# exponentials: 16 per clock per SM (the special-function unit), 132 SMs
# at the 1.98 GHz maximum SM clock of the H100 SXM
EXP_PER_S = 16 * 132 * 1.98e9
ROTATE_BYTES = 128 << 20  # inputs cycled per timing: over twice the L2


def events_ms(run, per: int, rounds: int = 5) -> float:
    """Median over `rounds` of CUDA-event time of `run()` divided by
    `per`, after a warm-up run."""
    run()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / per)
    return statistics.median(out)


def graph_ms(fns: list, min_calls: int = 20) -> float:
    """Device time per call of the callables `fns` (each on its own
    input buffer), captured back to back in one CUDA graph of at least
    `min_calls` calls."""
    calls = fns * max(1, -(-min_calls // len(fns)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in calls:
            f()
    ms = events_ms(graph.replay, len(calls))
    del graph
    return ms


def rotations(make, nbytes: int, cap: int | None = None) -> list:
    """Input sets from `make()`, each of `nbytes`, enough that together
    they outgrow the L2 (at most `cap` of them)."""
    n = max(1, -(-ROTATE_BYTES // nbytes))
    return [make() for _ in range(n if cap is None else min(cap, n))]


def bound(nbytes: float, ops_ms: float) -> dict:
    """The least time for work that moves `nbytes` through device memory
    and whose operations take `ops_ms` at their peak rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def attention_bound(shape, element_size: int) -> dict:
    """The least time of softmax(q . k^T) . v with q, k, v of `shape`
    (B, T, H, D): q, k, v read and o written once; QK^T and PV at the
    tensor (bf16) or FMA (f32) rate; one exponential per score."""
    b, t, h, d = shape
    flops_ms = 4 * b * h * t * t * d / (
        BF16_FLOPS if element_size == 2 else F32_FLOPS) * 1e3
    exp_ms = b * h * t * t / EXP_PER_S * 1e3
    return {**bound(4 * b * t * h * d * element_size, max(flops_ms, exp_ms)),
            "flops_ms": flops_ms, "exp_ms": exp_ms}


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
