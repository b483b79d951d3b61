"""Frozen operation and byte counts of kernel B5 (``csrc/ransac.cu``, the
region RANSAC of one view in one call), and its least time on one NVIDIA
H100 (SXM, 700 W).

A copy of ``tsar_mvs_tpu_torch/kernel_times.py``'s `b5_flops` and
`b5_bound`, kept here so that a change to the program cannot move its own
yardstick. Within one call both depend only on the call's work, as the
program's `ransac.fit` span records it: its regions R, their points P in
all, its rounds of 1000 hypotheses and its annealing rounds. Per region
and point: a residual (8 operations) for each round's 1000 hypotheses and
its threshold probe, and for each annealing step's candidate (4 a
round); per region: each hypothesis's plane (30) and each candidate (15).
Bytes: the points (12 B each), the triplets (12 B a hypothesis), the
perturbations (64 B an annealing round), the offsets and the per-region
inputs and outputs.
"""

from __future__ import annotations

from benchmark.counts.kernels import least_seconds

HYPOTHESES = 1000
FLOPS_PER_RESIDUAL = 8
FLOPS_PER_HYPOTHESIS = 30
FLOPS_PER_CANDIDATE = 15


def b5_counts(regions: int, points: int, rounds: int,
              anneal_rounds: int) -> tuple[int, int]:
    """(bytes, operations) of one B5 call."""
    R, P = regions, points
    nbytes = (12 * P + 12 * R * rounds * HYPOTHESES + 64 * R * anneal_rounds
              + 8 * (R + 1) + 12 * R + 24 * R)
    flops = (P * (rounds * (HYPOTHESES + 1) + 4 * anneal_rounds)
             * FLOPS_PER_RESIDUAL
             + R * (rounds * HYPOTHESES * FLOPS_PER_HYPOTHESIS
                    + 4 * anneal_rounds * FLOPS_PER_CANDIDATE))
    return nbytes, flops


def b5_least_seconds(calls) -> float:
    """B5's least seconds over `calls`, summed call by call: each a dict
    with `regions`, `points`, `rounds` and `anneal_rounds`."""
    return sum(least_seconds(*b5_counts(c["regions"], c["points"],
                                        c["rounds"], c["anneal_rounds"]))
               for c in calls)
