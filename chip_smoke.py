#!/usr/bin/env python3
"""Drive pyamg_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of the CUDA kernels from ``pyamg_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with each kernel's
   registers, shared memory, stack frame and spills from ``-Xptxas -v``;
2. kernels: K1 (banded SpMV) against its plain PyTorch version to 0 on
   every DIA operator of both paths (500^2 levels 0 and 1, 64^3 A0) and
   at 2048^2, float32 and float64; on a 2- and a 3-column x (one launch
   each), an x holding an inf and a NaN, an x off a 16-byte boundary, a
   band of 80 diagonals, a band wider than the offsets a launch takes by
   value (read from device memory), an ``npad`` that is not a multiple of
   4 with an n that is not a multiple of the rows a thread, and the
   one-sided band {-1500, -40, -1, 0}; K2 (multicolor Gauss-Seidel
   sweep, one launch a sweep) on the DIA operators of both paths (500^2
   levels 0 and 1 in the staged regime, 64^3 A0 in the regime that reads
   the band each pass), on 2-D Poisson 2048^2 (the band past shared
   memory), and in the staged regime on a one-sided band and on a band
   of 80 diagonals: symmetric, omega 1 and 0.8, float32 and float64, on
   an x holding an inf and a NaN and on a 2-column x, each to 0; the
   double-single ``two_prod`` against float64; K3 (SELL SpMV) on every
   SELL operator of the 3-D Poisson 64^3 hierarchy, on x and on x holding
   an inf and a NaN, and, in the K4 regime, on the SELL plan of 2-D Poisson
   1800^2; K5 (hybrid Gauss-Seidel) forward, backward and symmetric, omega
   1 and 0.8, on the 64^3 path's square SELL levels A1 and A2 (and on x
   holding inf and NaN) and, with x past shared memory, on the 1800^2 plan
   (off the main path);
3. main path: 2-D Poisson 500^2, grid smoothed aggregation, stencil
   compression, dense coarse tail, double-single refinement, solved to
   1e-10 on the card with the kernels' launch counts read around it, K1's
   launches and K2's launches and color passes per DIA level; then a 96^2
   solve on the card against the same solve on the CPU;
4. sa3d: 3-D Poisson 64^3, standard smoothed aggregation, DIA and SELL
   layouts, ``solve_refined(tol=1e-10, accel="cg")`` as
   ``bench_suite.bench_sa_poisson_3d_64`` runs it, with the launch counts
   read around the solve, per kernel, per SELL operator and per DIA level;
   then a 24^3 solve on the card against the same solve on the CPU;
5. times after a warm-up: for each path the warm solve (host clock) and
   one warm solve under torch.profiler, broken down into device busy
   time, idle share, device operations, host syncs and kernels by device
   time; one 500^2 V-cycle; and one row per kernel and operator (K1 and
   K2 on each DIA operator of both paths and at 2048^2, K3 on the six 64^3
   operators and in the K4 regime, K5 on A1 and A2) beside its byte
   bound, plain version and library call (device time per call from
   torch.profiler: the median of calls made with L2 flushed before each,
   for the kernel and the library call, and the mean with L2 warm; and
   CUDA events around back-to-back calls).  A bound counts each
   input read once and each output written once: for a SELL operator its
   stored non-zeros (value and column), not the padded slots of its plan.

6. solvers: S1-S6, the rest of the solve phase, against the JAX
   package's iteration counts (``solver_paths``, ``solvers_phase``);
7. classical: Ruge-Stuben on 2-D Poisson 500^2 and AIR-preconditioned
   GMRES on 2-D advection 256^2, built as ``bench_suite.py`` builds them:
   setup time by key, levels, operator complexity, layouts and SELL plans
   against the JAX package's (JAX_CLASSICAL); K1 on every DIA level the
   cycle multiplies by, K2 (each level's own sweep) on RS's DIA levels, K3
   on every SELL operator (and on inf/NaN at RS P0, R0 and AIR R0) and K5
   forward and backward on RS A3 and A4, each to 0 against its plain
   version; each solve driven with the counts reset around it (iterations
   within 1 of the JAX package's, true relative residual below 1e-10, the
   kernels launched per operator), warm and profiled; small solves on the
   card against the CPU; and time rows for the busiest new operators;
8. sa_more: smoothed aggregation on rotated anisotropic diffusion 512^2
   (evolution strength, grid aggregation; six 9-diagonal DIA levels) and
   on 2-D linear elasticity 100^2 (BELL levels of 2 x 2 and 3 x 3 blocks,
   rigid-body modes, block Gauss-Seidel), built as ``bench_suite.py``
   builds them: setup time by key, levels, blocksizes, operator
   complexity, layouts and DIA widths against the JAX package's (JAX_SA)
   before any solve; K1 on every anisotropic DIA level and K2 (each
   level's symmetric sweep) on every level it smooths, each to 0 against
   its plain version; each solve driven with the counts reset around it
   (K1 and K2 on every DIA level the cycle visits; no kernel on the
   elasticity path, whose ``bspmv`` and block smoothers are torch ops),
   warm and profiled; the elasticity fine level's ``bspmv``, block
   Gauss-Seidel color pass and sweep by their torch operations; 64^2 and
   24^2 solves on the card against the CPU; and time rows for K1 and K2
   on the anisotropic A0 and A3;
9. families: root-node SA (energy-minimising P, float64), pairwise
   aggregation (float32) and adaptive SA (one bootstrapped candidate,
   float64) on 2-D Poisson 500^2, built with their defaults and
   ``max_coarse=50``: setup time by key, levels, operator complexity,
   layouts, DIA widths and SELL plans against the JAX package's
   (JAX_FAMILIES) before any solve, and for adaptive SA the rows and rho
   of each trial hierarchy and ``work``; K1 and K2 (in the level's dtype)
   on every DIA level, K3 on every SELL operator and K5 forward and
   backward on every square SELL level, each to 0 against its plain
   version, and K3 on float32 SELL plans of the root-node P0 and R0 (off
   the path: its float64 transfers stay ELL); each solve driven with the
   counts reset around it, warm and profiled; 48^2 solves on the card
   against the CPU; and time rows for K1 and K2 on root-node A0, A1 and
   A4 and pairwise A6, K3 on pairwise P0 and R1 and the root-node plans,
   and K5 on pairwise A1;
10. blackbox: on 2-D Poisson 500^2 (b from ``default_rng(0).random``),
   BB, the one-call solve's own route (``solver`` of
   ``solver_configuration``, float64: evolution strength, energy
   smoothing, symmetric Gauss-Seidel; compressed; ``solve(A, b,
   tol=1e-10, existing_solver=ml)`` by CG), LL (SA with Lloyd
   aggregation, float32, compressed) and SZ (SA with strength-based
   Schwarz smoothing, ``keep=True``, float32, uncompressed): setup time
   by key, levels, operator complexity, layouts, DIA widths and SELL
   plans against the JAX package's (JAX_BLACKBOX) before any solve;
   every K1/K2/K3/K5 case on their operators to 0 against its plain
   version; each solve driven with the counts reset around it (SZ
   launches no kernel: its Schwarz sweeps are torch gathers and batched
   triangular solves), warm and profiled, and one V-cycle of each
   profiled with no host read; CG's warning on SZ; 48^2 solves on the
   card against the CPU (BB also fresh to 1e-8, uncompressed), and a
   compressed Schwarz hierarchy raising its TypeError; and time rows for
   K1 and K2 on BB A1 (27 diagonals, float64), K3 on LL P1 and R1 and K5
   on LL A1;
11. parallel: the row-sharded solve (``pyamg_tpu_torch.parallel``) in a
   one-rank NCCL group on the card, float64 SA on 2-D Poisson: the three
   flows of ``__graft_entry__.dryrun_multichip`` (CG for 3 iterations and
   2 standalone cycles on the gspmd path, 2 cycles on the halo path) at
   32^2 (``max_coarse=8``, ``replicate_below=64``) and at 500^2
   (``max_coarse=10``, ``replicate_below=2048``), the levels and each
   residual history against the JAX package's 4-device mesh
   (JAX_PARALLEL; 1e-10 at 32^2, 1e-9 at 500^2) and against the unsharded
   port in the same call, the halo CG to 1e-8 (the JAX package's
   iterations within 1, true relative residual below 1e-8) and no K1-K5
   launch around the sharded solves; at 500^2, for gspmd, halo and the
   unsharded hierarchy, the warm median of 5 CGs to 1e-8, one profiled,
   and the collectives per solve (counted by the port's wrappers, held
   against the NCCL kernels the trace shows), and one sharded V-cycle
   profiled with no host read, and the host cost of one all-gather and
   one all-reduce call; then each rank's step at 4 and 8 ranks
   emulated in one process (the halo product of A0, A1 and A2, the
   gathered product of P0 and R0) against the unsharded product on the
   card.  One rank carries no halo: the phase measures the sharded
   wrappers' own cost, not an exchange.

It then prints the kernel table as one JSON line and, last, the device
line.  Any failed check exits non-zero; without a CUDA device it exits
non-zero before printing a result.
"""

import functools
import json
import re
import statistics
import subprocess
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12              # H100 SXM float64 outside the tensor cores
                               # (data sheet)
SEED = 2022
# the JAX package's inner CG iterations per outer step on the 64^3 path
# (tests/jax_sell_reference.py 64, Pallas kernels in interpret mode on a
# CPU): the port's counts must equal them within 1
JAX_INNER_64 = (6, 7)
# (kind, t, passes, Sy) of the SELL operators at 64^3 and the layout of
# each level's (A, P, R)
SELL_64 = {"P0": ("tall", 8, 13, 2048), "R0": ("fat", 8, 152, 256),
           "A1": ("tall", 1, 66, 256), "P1": ("tall", 41, 11, 328),
           "R1": ("fat", 41, 839, 8), "A2": ("tall", 1, 89, 8)}
LAYOUT_64 = [("DIA", "SELL", "SELL"), ("SELL", "SELL", "SELL"),
             ("SELL", "ELL", "ELL"), ("DIA", "NoneType", "NoneType")]
# the JAX package's iterations on the solvers phase's paths (CPU, full
# size; JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
# tests/jax_solver_reference.py): S1-S5 iterations, S6 (outer, inner per
# outer); the port's must equal them within 1
JAX_SOLVERS = {"S1": 5, "S2": 7, "S3": 10, "S4": 16, "S5": 4,
               "S6": (2, (6, 8))}
# the JAX package's true relative residual on S1 (the same command): GMRES
# stops on the preconditioned residual, so S1's true one is held to twice
# the JAX package's, not to tol
JAX_S1_TRUE_RELRES = 4.6727206771483163e-05
# the JAX package's classical paths (JAX_PLATFORMS=cpu PYTHONPATH=.:tests
# python tests/jax_classical_reference.py; CPU, SELL kernels in interpret
# mode): rows of the levels, operator complexity, each level's (A, P, R)
# layout, the diagonals of each DIA level, each SELL operator's (kind, t,
# passes, Sy), outer and inner iterations and the true relative residual.
# The port's hierarchy must equal it, its inner iterations within 1
JAX_CLASSICAL = {
    "RS": {"rows": [250000, 125000, 31371, 7874, 1985, 509, 120, 29, 8],
           "operator_complexity": 2.19875,
           "layouts": [("DIA", "SELL", "SELL")] * 3 +
           [("SELL", "SELL", "SELL")] * 2 + [("DIA", "SELL", "SELL")] * 3 +
           [("DIA", "NoneType", "NoneType")],
           "dia": {"A0": 5, "A1": 11, "A2": 23, "A5": 25, "A6": 29,
                   "A7": 25, "A8": 11},
           "plans": {"P0": ("tall", 2, 5, 1960), "R0": ("fat", 2, 7, 984),
                     "P1": ("tall", 4, 4, 984), "R1": ("fat", 4, 9, 248),
                     "P2": ("tall", 4, 4, 248), "R2": ("fat", 4, 14, 64),
                     "A3": ("tall", 1, 14, 64), "P3": ("tall", 4, 4, 64),
                     "R3": ("fat", 4, 10, 16), "A4": ("tall", 1, 13, 16),
                     "P4": ("tall", 4, 4, 16), "R4": ("fat", 4, 9, 8),
                     "P5": ("tall", 4, 4, 8), "R5": ("fat", 4, 9, 8),
                     "P6": ("tall", 4, 4, 8), "R6": ("fat", 4, 10, 8),
                     "P7": ("tall", 4, 4, 8), "R7": ("fat", 4, 9, 8)},
           "outer": 2, "inner": (4, 4),
           "true_relres": 4.581865208238907e-11},
    "AIR": {"rows": [65025, 23718, 7917, 2317, 895, 17],
            "operator_complexity": 1.9621154883971936,
            "layouts": [("DIA", "SELL", "SELL")] +
            [("SELL", "SELL", "SELL")] * 4 +
            [("DIA", "NoneType", "NoneType")],
            "dia": {"A0": 3, "A5": 1},
            "plans": {"P0": ("tall", 3, 3, 576), "R0": ("fat", 3, 24, 192),
                      "A1": ("tall", 1, 7, 192), "P1": ("tall", 3, 1, 192),
                      "R1": ("fat", 3, 15, 64), "A2": ("tall", 1, 17, 64),
                      "P2": ("tall", 3, 1, 72), "R2": ("fat", 3, 14, 24),
                      "A3": ("tall", 1, 13, 24), "P3": ("tall", 3, 1, 24),
                      "R3": ("fat", 3, 8, 8), "A4": ("tall", 1, 9, 8),
                      "P4": ("tall", 53, 1, 424), "R4": ("fat", 53, 1, 8)},
            "outer": 2, "inner": (23, 21),
            "true_relres": 5.74217683939961e-11},
}
# the JAX package's smoothed-aggregation paths of bench_suite.py:83-138
# (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_sa_reference.py,
# CPU; with --small for JAX_SA_SMALL): rows and blocksize of the levels,
# operator complexity, each level's (A, P, R) layout, the diagonals of each
# DIA level, outer and inner iterations and the true relative residual.
# The port's hierarchy must equal it; the anisotropic solve's outer count
# within 1 and every inner count at most its cap of 60 (each inner CG stops
# at the cap), the elasticity solve's outer count exactly and its inner
# counts within 1
JAX_SA = {
    "anisotropic": {"rows": [262144, 29241, 3249, 361, 49, 9],
                    "blocksizes": [(1, 1)] * 6,
                    "operator_complexity": 1.124563352365929,
                    "layouts": [("DIA", "PhaseStencil", "PhaseStencil")] * 5
                    + [("DIA", "NoneType", "NoneType")],
                    "dia": {f"A{i}": 9 for i in range(6)},
                    "outer": 4, "inner": (60, 60, 60, 60),
                    "true_relres": 8.63e-13},
    "elasticity": {"rows": [20000, 3468, 432, 48],
                   "blocksizes": [(2, 2)] + [(3, 3)] * 3,
                   "operator_complexity": 1.2853925498851404,
                   "layouts": [("BELL", "BELL", "BELL")] * 3 +
                   [("BELL", "NoneType", "NoneType")],
                   "dia": {}, "outer": 2, "inner": (9, 9),
                   "true_relres": 3.95e-11},
}
JAX_SA_SMALL = {
    "anisotropic": {"rows": [4096, 484, 64, 9], "blocksizes": [(1, 1)] * 4,
                    "operator_complexity": 1.1282271468144045,
                    "layouts": [("DIA", "PhaseStencil", "PhaseStencil")] * 3
                    + [("DIA", "NoneType", "NoneType")],
                    "dia": {f"A{i}": 9 for i in range(4)},
                    "outer": 3, "inner": (28, 30, 39),
                    "true_relres": 9.822751874451589e-15},
    "elasticity": {"rows": [1152, 192, 27],
                   "blocksizes": [(2, 2), (3, 3), (3, 3)],
                   "operator_complexity": 1.2576020408163264,
                   "layouts": [("BELL", "BELL", "BELL")] * 2 +
                   [("BELL", "NoneType", "NoneType")],
                   "dia": {}, "outer": 2, "inner": (7, 7),
                   "true_relres": 3.965880083921101e-11},
}
# the JAX package's root-node, pairwise and adaptive SA paths on 2-D
# Poisson 500^2 (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
# tests/jax_families_reference.py, CPU, SELL kernels in interpret mode;
# with --small for JAX_FAMILIES_SMALL at 48^2): rows, operator complexity,
# each level's (A, P, R) layout, the diagonals of each DIA level, each
# SELL operator's (kind, t, passes, Sy), outer and inner iterations and the
# true relative residual; for adaptive SA ``work`` and each trial
# hierarchy's (rows, rho first measured on it).  The port's hierarchy must
# equal it (operator complexity within 1e-6, rho within 1e-8 relative),
# its iterations within 1 (iterations_near)
_DIA_ELL = [("DIA", "ELL", "ELL")] * 5 + [("DIA", "NoneType", "NoneType")]
_RN_ROWS = [250000, 41750, 4704, 532, 65, 9]
JAX_FAMILIES = {
    "RN": {"rows": _RN_ROWS, "operator_complexity": 1.3365945512820512,
           "layouts": _DIA_ELL,
           "dia": {"A0": 5, "A1": 11, "A2": 11, "A3": 11, "A4": 13, "A5": 15},
           "plans": {}, "outer": 2, "inner": (9, 9),
           "true_relres": 1.1744152066398591e-11},
    "PW": {"rows": [250000, 74167, 21972, 6447, 1901, 559, 159, 48],
           "operator_complexity": 1.5567203525641025,
           "layouts": [("DIA", "SELL", "ELL")] +
           [("SELL", "SELL", "SELL")] * 5 +
           [("DIA", "SELL", "SELL"), ("DIA", "NoneType", "NoneType")],
           "dia": {"A0": 5, "A6": 51, "A7": 25},
           "plans": {"P0": ("tall", 3, 5, 1968), "A1": ("tall", 1, 19, 1024),
                     "P1": ("tall", 3, 2, 600), "R1": ("fat", 3, 20, 200),
                     "A2": ("tall", 1, 11, 176), "P2": ("tall", 3, 1, 192),
                     "R2": ("fat", 3, 8, 64), "A3": ("tall", 1, 14, 56),
                     "P3": ("tall", 3, 1, 72), "R3": ("fat", 3, 4, 24),
                     "A4": ("tall", 1, 11, 16), "P4": ("tall", 3, 1, 24),
                     "R4": ("fat", 3, 4, 8), "A5": ("tall", 1, 11, 8),
                     "P5": ("tall", 4, 1, 8), "R5": ("fat", 4, 4, 8),
                     "P6": ("tall", 3, 1, 24), "R6": ("fat", 3, 4, 8)},
           "outer": 6, "inner": (60,) * 6,
           "true_relres": 2.7671180972372516e-11},
    "aSA": {"rows": _RN_ROWS, "operator_complexity": 1.3365945512820512,
            "layouts": _DIA_ELL,
            "dia": {"A0": 5, "A1": 11, "A2": 11, "A3": 11, "A4": 13,
                    "A5": 15},
            "plans": {}, "work": 48373705.0,
            "trials": [(_RN_ROWS, 0.5946364671694983),
                       (_RN_ROWS, 0.5916549989508952),
                       (_RN_ROWS, 0.5960526515450012), (_RN_ROWS, None)],
            "outer": 6, "inner": (60,) * 6,
            "true_relres": 3.9977638894590734e-12},
}
JAX_FAMILIES_SMALL = {
    "RN": {"rows": [2304, 396, 45], "operator_complexity": 1.3392478813559323,
           "outer": 2, "inner": (5, 6)},
    "PW": {"rows": [2304, 682, 206, 63, 19],
           "operator_complexity": 1.538665254237288, "outer": 2,
           "inner": (16, 17)},
    "aSA": {"rows": [2304, 396, 45], "operator_complexity": 1.3392478813559323,
            "outer": 2, "inner": (13, 14)},
}
# the JAX package's blackbox, Lloyd and Schwarz paths on 2-D Poisson 500^2
# (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
# tests/jax_blackbox_reference.py, CPU, SELL kernels in interpret mode;
# with --small for JAX_BLACKBOX_SMALL at 48^2): rows, operator complexity,
# each level's (A, P, R) layout, the diagonals of each DIA level, each SELL
# operator's (kind, t, passes, Sy), iterations (BB: CG's count; BB small
# also that of a fresh solve to 1e-8, which leaves its hierarchy
# uncompressed) and the true relative residual.  The port's hierarchy
# must equal it (operator complexity within 1e-6), BB's CG count within
# 1, LL's and SZ's outer count exactly and inner counts within 1
_LL_SELL = [("SELL", "SELL", "SELL")] * 3
JAX_BLACKBOX = {
    "BB": {"rows": [250000, 41750, 2893, 77],
           "operator_complexity": 1.8707419871794873,
           "layouts": [("DIA", "ELL", "ELL")] * 2 + [("ELL", "ELL", "ELL"),
                                                     ("ELL", "NoneType",
                                                      "NoneType")],
           "dia": {"A0": 5, "A1": 27}, "plans": {}, "cg": 16,
           "true_relres": 7.363e-11},
    "LL": {"rows": [250000, 25000, 2500, 250, 25],
           "operator_complexity": 1.2468149038461538,
           "layouts": [("DIA", "ELL", "ELL")] + _LL_SELL +
           [("DIA", "NoneType", "NoneType")],
           "dia": {"A0": 5, "A4": 49},
           "plans": {"A1": ("tall", 1, 128, 200), "P1": ("tall", 10, 27, 200),
                     "R1": ("fat", 10, 322, 24), "A2": ("tall", 1, 76, 24),
                     "P2": ("tall", 10, 10, 40), "R2": ("fat", 10, 171, 8),
                     "A3": ("tall", 1, 42, 8), "P3": ("tall", 10, 9, 40),
                     "R3": ("fat", 10, 111, 8)},
           "outer": 3, "inner": (15, 10, 11), "true_relres": 2.451e-12},
    "SZ": {"rows": _RN_ROWS, "operator_complexity": 1.3365945512820512,
           "layouts": [("ELL", "ELL", "ELL")] * 5 +
           [("ELL", "NoneType", "NoneType")], "dia": {}, "plans": {},
           "outer": 3, "inner": (15, 6, 6), "true_relres": 2.454e-12},
}
JAX_BLACKBOX_SMALL = {
    "BB": {"rows": [2304, 396], "operator_complexity": 1.7191031073446328,
           "cg": 10, "cg_fresh": 8},
    "LL": {"rows": [2304, 230, 23],
           "operator_complexity": 1.2124823446327684, "outer": 2,
           "inner": (10, 8)},
    "SZ": {"rows": [2304, 396, 45],
           "operator_complexity": 1.3392478813559323, "outer": 2,
           "inner": (7, 6)},
}
# inner CG's cap on both SA paths (bench_suite.py's inner_maxiter), and on
# the pairwise and adaptive SA paths
# tests/jax_parallel_reference.py: the JAX package's row-sharded solves on
# a 4-device mesh (float64 SA, b from default_rng(0).standard_normal): the
# rows of the levels, the sharded levels, the histories of CG for 3
# iterations (cg3), of 2 standalone cycles (sa2) and of 2 cycles on the
# halo path (halo2), and the halo CG's iterations to 1e-8
JAX_PARALLEL = {
    32: {"max_coarse": 8, "replicate_below": 64,
         "rows": [1024, 176, 24, 4], "sharded": [0, 1],
         "cg3": [31.139468020815205, 2.71430807204457, 0.14257747895192494,
                 0.01079375929446267],
         "sa2": [31.139468020815205, 2.221510256686357,
                 0.36195506102493935],
         "halo2": [31.139468020815205, 2.221510256686357,
                   0.36195506102493935],
         "halo_cg_iters": 7, "rtol": 1e-10},
    500: {"max_coarse": 10, "replicate_below": 2048,
          "rows": [250000, 41750, 4704, 532, 65, 9], "sharded": [0, 1, 2],
          "cg3": [500.47976676684607, 80.87845799227829, 4.066062310906942,
                  0.42761068265499413],
          "sa2": [500.47976676684607, 45.69808026534817, 9.310384397884661],
          "halo2": [500.47976676684607, 45.69808026534817,
                    9.310384397884661],
          "halo_cg_iters": 8, "rtol": 1e-9},
}

SA_INNER_CAP = 60
# the classical operators whose K3 case also takes an x holding inf and NaN
CLASSICAL_NON_FINITE = {("RS", "P0"), ("RS", "R0"), ("AIR", "R0")}
# the (omega, sweep) pairs the solvers phase adds to K2 and K5
SOLVER_K2_PAIRS = ((1.2, "symmetric"), (1.2, "forward"), (1.2, "backward"))
SOLVER_K5_PAIRS = ((1.2, "forward"), (1.2, "backward"))
# a profiler trace that comes back without its device operations is taken
# again, after a pause (an empty trace has come back whole after one)
TRACE_TRIES = 5
TRACE_PAUSE_S = 0.5
# small device operations run in a trace before the call it counts
TRACE_LEAD_IN = 256
# flushed calls made beyond those timed: a trace can come back without
# its first operations (up to 21 of them, 7 calls, seen in a trace of
# kernels that follow a 159,500-operation profile)
FLUSH_SPARE = 20


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def cuda_ms(fn, reps=200, warmup=10):
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_events(body, n):
    """The device operations that torch.profiler records over ``n`` calls
    of ``body``, in order of their start.  Every caller's body runs work on
    the device, so a trace that holds none (the profiler now and then
    returns one) is taken again after a pause, up to TRACE_TRIES times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for k in range(TRACE_TRIES):
        if k:
            time.sleep(TRACE_PAUSE_S)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                body()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events:
            break
    return events


def device_ms(fn, reps=50):
    """Mean device milliseconds per call of ``fn``: the kernel intervals
    that torch.profiler records over ``reps`` calls, summed.  Unlike
    events around back-to-back calls, this leaves out the host's time
    between launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    total_us = sum(e.time_range.end - e.time_range.start
                   for e in device_events(fn, reps))
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / reps / 1e3


def flush_ops(flush, reads=5):
    """The names of the device operations of a read through ``flush``,
    from a trace of ``reads`` reads (a trace can lose its first few
    operations, and then a trace of one read holds none)."""
    names = {e.name for e in device_events(flush.sum, reads)}
    check(names, "the trace of the L2 flush holds no device operation")
    return names


def flushed_ms(fn, flush, skip, reps=50):
    """Device milliseconds of each of the last ``reps`` of ``reps`` +
    FLUSH_SPARE calls of ``fn``, each made after reading through ``flush``
    (a tensor larger than the card's 50 MB L2), so that the call finds its
    inputs in device memory, not in L2.  The read's own operations
    (``skip``, from ``flush_ops``) mark the calls apart and are not
    counted.  A trace has come back without its first few calls (47 of
    50), hence the spare calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    check(not skip & {e.name for e in device_events(fn, 1)},
          "the L2 flush runs a kernel that the timed call runs too")

    def body():
        flush.sum()
        fn()

    made = reps + FLUSH_SPARE
    for k in range(TRACE_TRIES):    # a trace that lost operations is taken
        if k:                       # again
            time.sleep(TRACE_PAUSE_S)
        calls, cur = [], None
        events = device_events(body, made)
        for e in events:
            if e.name in skip:
                if cur is not None:
                    calls.append(cur)
                cur = None
            else:
                cur = (cur or 0.0) + e.time_range.end - e.time_range.start
        calls = (calls + [cur])[-reps:]
        if len(calls) == reps and all(c for c in calls):
            break
    marks = "".join("f" if e.name in skip else "k" for e in events)
    check(len(calls) == reps and all(c for c in calls),
          f"{len(calls)} of the last {reps} flushed calls traced, {made} "
          f"made (trace: {marks}, f the flush, k the call)")
    return [c / 1e3 for c in calls]


def rel_err(got, want):
    """(max |got - want|, max |want|)."""
    return (float((got - want).abs().max()), float(want.abs().max()))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def build_hierarchy(N, max_n, device, ds=True, dtype=np.float32, **kw):
    """The main path's setup on 2-D Poisson N^2 (``kw`` to
    ``smoothed_aggregation_solver``): (A64, ml, levels and operator
    complexity of the hierarchy before the coarse collapse)."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    A64 = poisson((N, N))
    ml = smoothed_aggregation_solver(A64.astype(dtype),
                                     aggregate=("grid", {}), max_coarse=10,
                                     **kw)
    full = (len(ml.levels), ml.operator_complexity())
    ml.compress_stencils()
    if max_n:
        ml.collapse_coarse(max_n=max_n, device=device)
    if ds:
        ml.enable_ds_refinement(A64, device=device)
    return A64, ml, full


def ptxas_report(log):
    """[(kernel, registers, shared-memory bytes, stack frame, spill
    stores, spill loads)] from an ``nvcc -Xptxas -v`` log."""
    out, name, spills = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = name = m.group(1)
            # <length><identifier> pieces of the mangled name
            for k in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
                ident = k.group(2)[:int(k.group(1))]
                if ident.endswith("_kernel"):
                    name = ident
            args = re.search(r"_kernelI(.+?)EEv", mangled)
            if args:
                name += "<" + ",".join(
                    a.replace("Li", ",").replace("Lb0", "false")
                    .replace("Lb1", "true").strip(",")
                    for a in args.group(1).split("E") if a) + ">"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spills = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)),
                        int(smem.group(1)) if smem else 0, *spills))
            name, spills = None, (0, 0, 0)
    return out


def same_non_finite(got, want):
    """Whether two vectors are non-finite (inf, NaN) at the same places."""
    import torch
    return bool(torch.equal(torch.isfinite(got), torch.isfinite(want)) and
                torch.equal(torch.isnan(got), torch.isnan(want)))


def non_finite(x):
    """A copy of x with an inf at a third and a NaN at two thirds."""
    x = x.clone()
    x[x.shape[0] // 3] = float("inf")
    x[2 * x.shape[0] // 3] = float("nan")
    return x


def build_kernels():
    """Build every CUDA source of the port at once (one nvcc each)."""
    from concurrent.futures import ThreadPoolExecutor
    from pyamg_tpu_torch.ops import dia_kernels, sell_kernels
    with ThreadPoolExecutor(2) as pool:
        futures = [(m.__name__.rsplit(".", 1)[-1], pool.submit(m.build))
                   for m in (dia_kernels, sell_kernels)]
        return {name: f.result() for name, f in futures}


def build_sa3d(N, **kw):
    """The 3-D Poisson N^3 path's setup (``bench_suite.py:65-80``; ``kw``
    to ``smoothed_aggregation_solver``): (A64, ml) with standard smoothed
    aggregation, ``max_coarse=50``, stencils compressed (DIA and SELL)."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    A64 = poisson((N, N, N))
    ml = smoothed_aggregation_solver(A64.astype(np.float32), max_coarse=50,
                                     **kw)
    return A64, ml.compress_stencils()


def sell_operators(ml):
    """{name: (placed SELL, host ELL original)} of a compressed hierarchy."""
    from pyamg_tpu_torch.sparse.sell import SELL
    out = {}
    for i, lvl in enumerate(ml.levels):
        for attr in "APR":
            op = getattr(lvl, attr)
            if isinstance(op, SELL):
                out[f"{attr}{i}"] = (op, getattr(lvl, attr + "_ell"))
    return out


def layout(ml):
    return [tuple(type(getattr(l, a)).__name__ for a in "APR")
            for l in ml.levels]


def csr_on(S, device, dtype=None):
    """A scipy matrix as a torch CSR tensor (the library yardstick), in
    float32 unless ``dtype`` says otherwise."""
    import torch
    S = S.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(S.indptr, dtype=torch.int64),
        torch.as_tensor(S.indices, dtype=torch.int64),
        torch.as_tensor(S.data, dtype=dtype or torch.float32), size=S.shape,
        device=device)


def profiled(fn):
    """Run ``fn`` once under torch.profiler: (wall us, device busy us,
    device ops [(name, start, end)], host syncs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for k in range(TRACE_TRIES):    # as device_events: a trace with no
        if k:                       # device operation is taken again
            time.sleep(TRACE_PAUSE_S)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ops, syncs = [], 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ops.append((e.name, e.time_range.start, e.time_range.end))
            elif e.name == "aten::_local_scalar_dense":
                syncs += 1
        if ops:
            break
    busy = busy_us([(s, t) for _, s, t in ops])
    check(busy > 0, "the profiled solve ran nothing on the device")
    return wall_us, busy, ops, syncs


def print_profile(tag, wall_us, busy, ops, syncs, top=12, phase="times"):
    print(f"{phase}: {tag} profiled warm solve wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.4f}, device ops {len(ops)}, host syncs "
          f"{syncs}")
    by_name = {}
    for name, s, t in ops:
        c, d = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, d + (t - s))
    for name, (c, d) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:top]:
        print(f"{phase}: {tag} device {d:9.1f} us = {c:5d} x {d / c:7.2f} "
              f"us  {name[:90]}")


def solver_paths(dev, N2=500, N3=64):
    """The paths of the ``solvers:`` phase: [(name, what it runs, run,
    scipy A, b, tol, kernels it must launch, M)], ``run(residuals)``
    returning (x, info).  The true relative residual is checked below tol,
    except S1's: GMRES stops on the preconditioned residual, and a true
    relative residual below 1e-6 is not what it promises (the JAX
    package's own S1 stops at 4.7e-5), so S1's is checked through its
    preconditioner ``M`` (||M (b - A x)|| / ||M b|| in float64 below tol)
    and its true one against the JAX package's (``solvers_phase``).
    S1-S5 on 2-D Poisson N2^2, grid SA, float64 (in
    float32 no path reaches a true relative residual of 1e-6 at 500^2,
    the JAX package's neither: ``tests/jax_solver_reference.py
    --float32``); S6 on 3-D Poisson N3^3, standard SA, float32 (SELL)."""
    import torch
    from pyamg_tpu_torch import krylov
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    A64, s1, _ = build_hierarchy(N2, 4096, dev, ds=False, dtype=np.float64)
    s1.to_device(dev)

    def grid_sa(smoother, **kw):
        _, ml, _ = build_hierarchy(N2, 0, dev, ds=False, dtype=np.float64,
                                   presmoother=smoother,
                                   postsmoother=smoother, **kw)
        return ml.to_device(dev)

    s2 = grid_sa(("sor", {"omega": 1.2, "sweep": "symmetric"}),
                 coarse_solver="splu")
    s3 = grid_sa(("chebyshev", {"degree": 3}), coarse_solver="cholesky")
    s4 = grid_sa(("jacobi", {"omega": 4.0 / 3.0, "iterations": 2}))
    S2, b = to_scipy(A64), np.random.default_rng(SEED).standard_normal(
        A64.shape[0])
    A3, s6 = build_sa3d(N3, presmoother=("sor", {"omega": 1.2,
                                                 "sweep": "forward"}),
                        postsmoother=("sor", {"omega": 1.2,
                                              "sweep": "backward"}))
    s6.to_device(dev)
    S3, b3 = to_scipy(A3), np.random.default_rng(0).standard_normal(
        A3.shape[0])
    dia = ("dia_spmv", "dia_gs_sweep")
    M1 = s1.aspreconditioner("W")

    def s1_precond(v):
        return M1.matvec(torch.as_tensor(v, device=dev)).cpu().numpy()

    def s6_run(res):
        it = {}
        x = s6.solve_refined(b3, A_fine=S3, tol=1e-10, accel="gmres",
                             cycle="W", residuals=res, iterations_out=it)
        return x, (it["outer"], tuple(it["inner"]))

    return [
        ("S1", "GMRES around a W-cycle, symmetric GS, dense coarse tail",
         lambda res: s1.solve(b, tol=1e-6, accel="gmres", cycle="W",
                              residuals=res, return_info=True),
         S2, b, 1e-6, dia, s1_precond),
        ("S2", "FGMRES around an F-cycle, SOR omega 1.2, LU coarse solve",
         lambda res: s2.solve(b, tol=1e-6, accel="fgmres", cycle="F",
                              residuals=res, return_info=True),
         S2, b, 1e-6, dia, None),
        ("S3", "CG around a V-cycle, Chebyshev degree 3, Cholesky coarse "
         "solve", lambda res: s3.solve(b, tol=1e-6, accel="cg",
                                       residuals=res, return_info=True),
         S2, b, 1e-6, ("dia_spmv",), None),
        ("S4", "standalone AMLI cycling, Jacobi omega 4/3 twice",
         lambda res: s4.solve(b, tol=1e-6, cycle="AMLI", maxiter=60,
                              residuals=res, return_info=True),
         S2, b, 1e-6, ("dia_spmv",), None),
        ("S5", "krylov.bicgstab preconditioned by S1's V-cycle",
         lambda res: krylov.bicgstab(s1.levels[0].A, b, tol=1e-6,
                                     M=s1.aspreconditioner("V"),
                                     residuals=res),
         S2, b, 1e-6, dia, None),
        ("S6", "solve_refined GMRES around a W-cycle, SOR omega 1.2 forward "
         "and backward", s6_run, S3, b3, 1e-10,
         dia + ("sell_spmv", "sell_gs_sweep"), None),
    ]


def solvers_phase(dev, paths, jax_counts, jax_s1_relres, reps=5):
    """Drive each path once cold with the launch counts set to 0 just
    before it and read just after, then ``reps`` warm solves and one
    profiled; check the iterations against the JAX package's within 1,
    the true relative residual below tol (S1's preconditioned one below
    tol and its true one at most twice ``jax_s1_relres``, the JAX
    package's), the kernels the path runs and no CG warning.  Returns
    {name: launches per kernel}."""
    import warnings
    import torch
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import sell_kernels as sk
    kernels = dk.KERNELS + sk.KERNELS
    out = {}
    for name, what, run, S, b, tol, must, M in paths:
        dk.reset_launch_counts()
        sk.reset_launch_counts()
        res = []
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            x, info = run(res)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        per_op = {k.__name__: dict(getattr(k, "by_op", None) or k.by_plan)
                  for k in kernels if k.launches}
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        r = b - S @ x.astype(np.float64)
        relres = float(np.linalg.norm(r) / np.linalg.norm(b))
        gated = relres if M is None else \
            float(np.linalg.norm(M(r)) / np.linalg.norm(M(b)))
        its = info if name == "S6" else len(res) - 1
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run([])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"solvers: {name} {what}: iterations {its} (JAX package "
              f"{jax_counts[name]}), info {info}, true_relres {relres:.3e}"
              + ("" if M is None else f" (JAX package "
                 f"{jax_s1_relres:.3e}), preconditioned {gated:.3e}") +
              f" (tol {tol:g}), warnings {[str(w.message)[:60] for w in warned]}"
              f", cold {cold:.3f} s, warm median of {reps} "
              f"{statistics.median(walls) * 1e3:.3f} ms (all "
              f"{[round(w * 1e3, 3) for w in walls]}), launches per solve "
              f"{launches}, per operator {per_op}")
        print_profile(name, *profiled(lambda: run([])), phase="solvers")
        want = jax_counts[name]
        if name == "S6":
            check(its[0] == want[0] and len(its[1]) == len(want[1]) and
                  all(abs(a - c) <= 1 for a, c in zip(its[1], want[1])),
                  f"{name}: iterations {its} differ from the JAX package's "
                  f"{want} by more than 1")
        else:
            check(abs(its - want) <= 1, f"{name}: {its} iterations, the JAX "
                                        f"package {want}")
        check(x.shape == b.shape and np.isfinite(x).all() and gated < tol,
              f"{name}: true relative residual {gated:.3e} not below {tol}")
        check(M is None or relres <= 2 * jax_s1_relres,
              f"{name}: true relative residual {relres:.3e} above twice the "
              f"JAX package's {jax_s1_relres:.3e}")
        check(all(launches[k] > 0 for k in must) and
              all(v == 0 for k, v in launches.items() if k not in must),
              f"{name}: launches {launches}, expected exactly {must}")
        check(name != "S3" or not warned, f"{name} raised a warning")
        out[name] = launches
    return out


def kernel_row(flush, skip, name, replaces, launches, err, fn, plain, library,
               nbytes, ops, source="pyamg_tpu_torch/csrc/dia_kernels.cu",
               plain_reps=50, tag=None, peak=F32_FLOPS):
    """A kernel's line: device times per call (profiler; the kernel's
    and the library call's the median of calls made with L2 flushed,
    and also their mean L2-warm), and its bound, the larger of bytes
    over the memory rate and operations over ``peak``, the rate of their
    type (float32 by default).  ``flush`` is read before each flushed
    call, and ``skip`` names its device operations (``flush_ops``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    cold = flushed_ms(fn, flush, skip)
    r = {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches, "max_abs_err": err,
         "ms": statistics.median(cold),
         "plain_ms": device_ms(plain, plain_reps),
         "bound_ms": max(t_bytes, t_ops) * 1e3,
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": None if library is None else
         statistics.median(flushed_ms(library, flush, skip))}
    lib = "-" if library is None else \
        f"{r['library_ms'] * 1e3:.2f} us (L2 flushed, median; " \
        f"{device_ms(library) * 1e3:.2f} us L2-warm)"
    print(f"times: {tag or name} device {r['ms'] * 1e3:.2f} us per call "
          f"with L2 flushed (median; {min(cold) * 1e3:.2f}-"
          f"{max(cold) * 1e3:.2f} us over {len(cold)} calls), "
          f"{device_ms(fn) * 1e3:.2f} us L2-warm "
          f"({cuda_ms(fn) * 1e3:.2f} us per call with the host), bound "
          f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}, "
          f"{nbytes / 1e6:.2f} MB), plain {r['plain_ms'] * 1e3:.2f} us "
          f"(L2-warm), library {lib}, launches on the main path "
          f"{launches}")
    return r


def classical_paths(dev, n_rs=500, n_air=256):
    """The ``classical:`` phase's paths, built as ``bench_suite.py`` builds
    them (``:47-62`` and ``:141-162``), compressed and placed on ``dev``:
    Ruge-Stuben on 2-D Poisson n_rs^2 (float32, defaults, CG, b from
    ``default_rng(0)``) and AIR on 2-D advection n_air^2 (float32, PMIS,
    ``filter_operator=(False, 0.1)``, GMRES, b the gallery's rhs).  Each a
    dict: name, scipy A, ml, b, solve options, setup seconds and by key,
    and the kernels the solve must launch (and no other)."""
    from pyamg_tpu_torch.classical import air_solver, ruge_stuben_solver
    from pyamg_tpu_torch.gallery import advection_2d, poisson
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    A_rs = poisson((n_rs, n_rs))
    A_air, rhs = advection_2d((n_air, n_air))
    specs = [
        ("RS", A_rs, np.random.default_rng(0).standard_normal(A_rs.shape[0]),
         ruge_stuben_solver, {"accel": "cg"},
         ("dia_spmv", "dia_gs_sweep", "sell_spmv", "sell_gs_sweep")),
        ("AIR", A_air, np.asarray(rhs, np.float64),
         lambda A: air_solver(A, CF="PMIS", filter_operator=(False, 0.1)),
         {"accel": "gmres", "inner_maxiter": 40, "max_outer": 20},
         ("dia_spmv", "sell_spmv"))]
    out = []
    for name, A64, b, make, kw, must in specs:
        t0 = time.perf_counter()
        ml = make(A64.astype(np.float32))
        setup = time.perf_counter() - t0
        ml.compress_stencils()
        ml.to_device(dev)
        out.append({"name": name, "S": to_scipy(A64), "ml": ml, "b": b,
                    "kw": kw, "setup_s": setup,
                    "by_key": ml.setup_timings(), "must": must})
    return out


def classical_describe(ml):
    """What ``tests/jax_classical_reference.py`` prints of a hierarchy: rows,
    operator complexity, layouts, DIA widths and SELL plans."""
    from pyamg_tpu_torch.sparse.matrix import DIA
    from pyamg_tpu_torch.sparse.sell import SELL
    dia, plans = {}, {}
    for i, lvl in enumerate(ml.levels):
        for attr in "APR":
            op = getattr(lvl, attr)
            if isinstance(op, DIA):
                dia[f"{attr}{i}"] = len(op.offsets)
            elif isinstance(op, SELL):
                plans[f"{attr}{i}"] = (op.kind, op.t, op.n_passes, op.Sy)
    return {"rows": [lvl.A.shape[0] for lvl in ml.levels],
            "operator_complexity": ml.operator_complexity(),
            "layouts": layout(ml), "dia": dia, "plans": plans}


def path_kernels(dev, path, rng, sms, phase="classical", coarsest=False):
    """Every kernel the path's solve runs, on its operators, against the
    plain version to 0: K1 (in the level's dtype) on each DIA level the
    cycle multiplies by (and on the coarsest with ``coarsest``), K2 (the
    level's own sweep: its colors, color order and omega) on each DIA
    level, K3 on every SELL operator (and on an x holding inf and NaN
    where CLASSICAL_NON_FINITE says), K5 forward and backward on each
    square SELL level.  Returns the inputs of each case, by
    "K<k> <operator>", for the timing rows."""
    import torch
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import sell_kernels as sk
    from pyamg_tpu_torch.relaxation.relaxation import gs_order
    from pyamg_tpu_torch.sparse.matrix import DIA
    from pyamg_tpu_torch.sparse.sell import LANE, SELL
    tag, ml = path["name"], path["ml"]

    def vec(n, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)

    inputs = {}
    # the coarsest level is solved by pinv: K1 there only with coarsest
    for i, lvl in enumerate(ml.levels[:None if coarsest else -1]):
        D = lvl.A
        if isinstance(D, DIA):
            n, offs = D.shape[0], D.offsets
            x = vec(n, D.data.dtype)
            before = dk.dia_spmv.launches
            y = dk.dia_spmv(D.data, offs, n, x)
            launched = dk.dia_spmv.launches - before
            want = dk.dia_spmv_plain(D.data, offs, n, x)
            torch.cuda.synchronize()
            err, _ = rel_err(y, want)
            es = D.data.element_size()
            print(f"{phase}: K1 {tag} A{i} {str(D.data.dtype)[6:]} n={n} "
                  f"ndiag={len(offs)} "
                  f"{dk.spmv_geometry(n, 1, D.data.shape[1], es, sms)} "
                  f"launches {launched} max_abs_err={err:.3e}")
            check(err == 0 and launched == 1,
                  f"K1 {tag} A{i} disagrees with its plain version or took "
                  f"{launched} launches")
            inputs[f"K1 A{i}"] = (D, x, err)
            if lvl.pre[0] == "gauss_seidel":
                _, so, params = lvl.pre
                order = gs_order(so["ncolors"], so["sweep"],
                                 so["iterations"], so["omega"])
                b = vec(n, D.data.dtype)
                args = (D.data, offs, n, x, b, params["Dinv"],
                        params["colors"], order, so["omega"])
                got = dk.dia_gs_sweep(*args)
                want = dk.dia_gs_sweep_plain(*args)
                torch.cuda.synchronize()
                err, _ = rel_err(got, want)
                g = dk.gs_geometry(n, len(offs), max(abs(o) for o in offs),
                                   es, sms)
                print(f"{phase}: K2 {tag} A{i} {so['sweep']} omega="
                      f"{so['omega']} order={order} {g} "
                      f"max_abs_err={err:.3e}")
                check(err == 0, f"K2 {tag} A{i} disagrees with its plain "
                                f"version")
                inputs[f"K2 A{i}"] = (D, x, b, params["Dinv"],
                                      params["colors"], order, err)
        for attr in "APR":
            S = getattr(lvl, attr)
            if not isinstance(S, SELL):
                continue
            name = f"{attr}{i}"
            x = vec(S.shape[1])
            y, want = sk.sell_spmv(S, x), sk.sell_spmv_plain(S, x)
            torch.cuda.synchronize()
            err, _ = rel_err(y, want)
            msg = ""
            if (tag, name) in CLASSICAL_NON_FINITE:
                xn = non_finite(x)
                yn, wantn = sk.sell_spmv(S, xn), sk.sell_spmv_plain(S, xn)
                torch.cuda.synchronize()
                fin = torch.isfinite(wantn)
                errn = float((yn[fin] - wantn[fin]).abs().max())
                same = same_non_finite(yn, wantn)
                msg = (f"; x with inf and NaN: {int((~fin).sum())} "
                       f"non-finite, same places {same}, "
                       f"max_abs_err={errn:.3e}")
                check(same and errn == 0, f"K3 {tag} {name} disagrees with "
                      f"its plain version on an x holding inf and NaN")
            print(f"{phase}: K3 {tag} {name} {S.kind}/{S.t} {S.shape} "
                  f"passes {S.n_passes} K={S.K} Sy={S.Sy} "
                  f"{sk.spmv_geometry(S.n_passes, S.shape[0])} "
                  f"max_abs_err={err:.3e}{msg}")
            check(err == 0, f"K3 {tag} {name} disagrees with its plain "
                            f"version")
            inputs[f"K3 {name}"] = (S, getattr(lvl, attr + "_ell"), x, err)
        if isinstance(D, SELL) and lvl.pre[0] == "gauss_seidel":
            Dinv = lvl.pre[2]["Dinv"]
            n = D.shape[0]
            x, b = vec(n), vec(n)
            print(f"{phase}: K5 {tag} A{i} n={n} passes {D.n_passes} "
                  f"{sk.gs_geometry(D.n_passes, D.Sy * LANE)}")
            for sweep in ("forward", "backward"):
                got = sk.sell_gs_sweep(D, x, b, Dinv, 1.0, sweep)
                want = sk.sell_gs_sweep_plain(D, x, b, Dinv, 1.0, sweep)
                torch.cuda.synchronize()
                err, _ = rel_err(got, want)
                print(f"{phase}: K5 {tag} A{i} {sweep} omega=1.0 "
                      f"max_abs_err={err:.3e}")
                check(err == 0, f"K5 {tag} A{i} {sweep} disagrees with its "
                                f"plain version")
                if sweep == "forward":
                    inputs[f"K5 A{i}"] = (D, x, b, Dinv, err)
    return inputs


def path_launches(ml):
    """{kernel: {operator: launches}} of the last solve on ``ml``, from the
    wrappers' per-operator counters (DIA levels by (n, diagonals), SELL
    operators by plan)."""
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import sell_kernels as sk
    from pyamg_tpu_torch.sparse.matrix import DIA
    from pyamg_tpu_torch.sparse.sell import SELL
    out = {k.__name__: {} for k in dk.KERNELS + sk.KERNELS}
    for i, lvl in enumerate(ml.levels):
        for attr in "APR":
            op = getattr(lvl, attr)
            name = f"{attr}{i}"
            if isinstance(op, DIA):
                key = (op.shape[0], len(op.offsets))
                out["dia_spmv"][name] = dk.dia_spmv.by_op[key]
                if lvl.pre[0] == "gauss_seidel":
                    out["dia_gs_sweep"][name] = dk.dia_gs_sweep.by_op[key]
            elif isinstance(op, SELL):
                key = sk.plan_key(op)
                out["sell_spmv"][name] = sk.sell_spmv.by_plan[key]
                if attr == "A" and lvl.pre[0] == "gauss_seidel":
                    out["sell_gs_sweep"][name] = \
                        sk.sell_gs_sweep.by_plan[key]
    return out


def iterations_near(it, want):
    """The JAX package's outer count, each inner count within 1."""
    return (it["outer"] == want["outer"] and
            len(it["inner"]) == len(want["inner"]) and
            all(abs(a - c) <= 1 for a, c in zip(it["inner"], want["inner"])))


def drive_path(path, want, reps=5, phase="classical"):
    """Drive one path as a user does: ``solve_refined`` to 1e-10 (or the
    path's own ``solve(residuals=, iterations_out=)``, returning x as
    numpy) with the launch counts set to 0 just before and read just
    after; then ``reps`` warm solves and one profiled.  Checks the
    iterations (the path's ``iterations_ok``, by default
    ``iterations_near`` the JAX package's), the true relative residual
    below 1e-10 and the kernels launched: those the path must launch, on
    every operator of the cycle, and no other.
    Returns (launches per kernel, per operator, warm median seconds)."""
    import torch
    tag, ml, S, b, kw = (path[k] for k in ("name", "ml", "S", "b", "kw"))

    def refined(**extra):
        return ml.solve_refined(b, A_fine=S, tol=1e-10, **kw, **extra)

    solve = path.get("solve", refined)

    reset_kernel_launches()
    it, res = {}, []
    t0 = time.perf_counter()
    x = solve(residuals=res, iterations_out=it)
    cold = time.perf_counter() - t0
    launches = kernel_launches()
    per_op = path_launches(ml)
    relres = float(np.linalg.norm(b - S @ x) / np.linalg.norm(b))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ref_it = {k: want[k] for k in ("outer", "inner", "cg") if k in want}
    print(f"{phase}: {tag} cold solve {cold:.3f} s, iterations {it} (JAX "
          f"package {ref_it}), true_relres "
          f"{relres:.3e} (JAX package {want['true_relres']:.3e}), residuals "
          f"{res}, warm median of {reps} "
          f"{statistics.median(walls) * 1e3:.3f} ms (all "
          f"{[round(w * 1e3, 3) for w in walls]}), launches per solve "
          f"{launches}, per operator {per_op}")
    print_profile(tag, *profiled(solve), phase=phase)
    check(x.shape == b.shape and np.isfinite(x).all(),
          f"{tag}: x is not a finite vector of the right shape")
    ok, rule = path.get("iterations_ok", (iterations_near, "within 1"))
    check(ok(it, want), f"{tag}: iterations {it} against the JAX package's "
                        f"{ref_it}: not {rule}")
    check(relres < 1e-10, f"{tag}: true relative residual {relres:.3e} not "
                          f"below 1e-10")
    check(all(launches[k] > 0 for k in path["must"]) and
          all(v == 0 for k, v in launches.items() if k not in path["must"]),
          f"{tag}: launches {launches}, expected exactly {path['must']}")
    # every operator of the cycle ran its kernels (the coarsest A is solved
    # directly), and the operators add up to each kernel's total
    coarsest = f"A{len(ml.levels) - 1}"
    check(all(v > 0 for d in per_op.values() for k, v in d.items()
              if k != coarsest) and
          all(sum(per_op[k].values()) == launches[k] for k in per_op),
          f"{tag}: an operator of the cycle was never launched, or the "
          f"per-operator counts do not add up to the kernels' totals")
    return launches, per_op, statistics.median(walls)


def classical_phase(dev, sms, rng, want=None, n_rs=500, n_air=256, reps=5):
    """The ``classical:`` phase: build both paths and print their setup,
    hierarchy and launch shapes; hold every kernel case against its plain
    version; gate the hierarchies against ``want`` (JAX_CLASSICAL); drive
    each path; then solve both at 96^2 and 64^2 on ``dev`` and on the CPU,
    which must agree to 1e-9.  Returns ({path: kernel inputs}, {path:
    launches per operator})."""
    want = JAX_CLASSICAL if want is None else want
    paths = classical_paths(dev, n_rs, n_air)
    inputs, per_ops = {}, {}
    for path in paths:
        gate_hierarchy("classical", path, want[path["name"]])
        inputs[path["name"]] = path_kernels(dev, path, rng, sms)
    for path in paths:
        _, per_ops[path["name"]], _ = drive_path(path, want[path["name"]],
                                                 reps)
    # the same small solves on the card and on the CPU (plain versions)
    xs = {}
    for d in ("cuda", "cpu"):
        xs[d] = [p["ml"].solve_refined(p["b"], A_fine=p["S"], tol=1e-10,
                                       **p["kw"])
                 for p in classical_paths(d, 96, 64)]
    for p, xc, xh in zip(paths, xs["cuda"], xs["cpu"]):
        diff = float(np.linalg.norm(xc - xh) / np.linalg.norm(xh))
        print(f"classical: {p['name']} small solve, card vs CPU relative "
              f"difference {diff:.3e} (tol 1e-9)")
        check(diff < 1e-9, f"{p['name']}: the card's small solve disagrees "
                           f"with the CPU's")
    return inputs, per_ops


def sa_more_paths(dev, n_aniso=512, n_el=100):
    """The ``sa_more:`` phase's paths, built as ``bench_suite.py`` builds
    them (``:83-118`` and ``:121-138``), compressed and placed on ``dev``:
    rotated anisotropic diffusion (epsilon 1e-3, theta pi/8, FE) on
    n_aniso^2 with evolution strength and grid aggregation,
    ``max_coarse=20``; 2-D linear elasticity on n_el^2 (2 x 2 blocks) with
    its rigid-body modes as B, ``max_coarse=50``; float32, each solved by
    ``solve_refined(tol=1e-10, accel="cg", inner_maxiter=60,
    max_outer=20)``, b from ``default_rng(0)``.  Each a dict as
    ``classical_paths`` gives, with the path's iteration rule."""
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import (diffusion_stencil_2d,
                                         linear_elasticity, stencil_grid)
    from pyamg_tpu_torch.sparse.matrix import to_scipy

    def outer_near_inner_capped(it, want):
        return (abs(it["outer"] - want["outer"]) <= 1 and
                all(k <= SA_INNER_CAP for k in it["inner"]))

    st = diffusion_stencil_2d(epsilon=1e-3, theta=np.pi / 8, type="FE")
    A_el, B_el = linear_elasticity((n_el, n_el))
    specs = [
        ("anisotropic", stencil_grid(st, (n_aniso, n_aniso)), None,
         {"strength": ("evolution", {}), "aggregate": ("grid", {}),
          "max_coarse": 20}, ("dia_spmv", "dia_gs_sweep"),
         (outer_near_inner_capped,
          f"outer within 1 and every inner at most {SA_INNER_CAP}")),
        ("elasticity", A_el, B_el, {"max_coarse": 50}, (),
         (iterations_near, "within 1"))]
    out = []
    for name, A64, B, kw, must, rule in specs:
        t0 = time.perf_counter()
        ml = smoothed_aggregation_solver(A64.astype(np.float32), B=B, **kw)
        setup = time.perf_counter() - t0
        ml.compress_stencils()
        ml.to_device(dev)
        out.append({"name": name, "S": to_scipy(A64).tocsr(), "ml": ml,
                    "b": np.random.default_rng(0).standard_normal(
                        A64.shape[0]),
                    "kw": {"accel": "cg", "inner_maxiter": SA_INNER_CAP,
                           "max_outer": 20},
                    "setup_s": setup, "by_key": ml.setup_timings(),
                    "must": must, "iterations_ok": rule})
    return out


def sa_more_describe(ml):
    """What ``tests/jax_sa_reference.py`` prints of a hierarchy: rows,
    blocksizes, operator complexity, layouts and DIA widths."""
    from pyamg_tpu_torch.sparse.matrix import BELL, DIA
    dia = {}
    for i, lvl in enumerate(ml.levels):
        for attr in "APR":
            if isinstance(getattr(lvl, attr), DIA):
                dia[f"{attr}{i}"] = len(getattr(lvl, attr).offsets)
    return {"rows": [lvl.A.shape[0] for lvl in ml.levels],
            "blocksizes": [lvl.A.blocksize if isinstance(lvl.A, BELL)
                           else (1, 1) for lvl in ml.levels],
            "operator_complexity": ml.operator_complexity(),
            "layouts": layout(ml), "dia": dia}


def ops_per_call(fn, flush, skip, reps=20):
    """{device operation: (launches per call, mean us per launch)} of
    ``fn``, from the last ``reps`` of ``reps`` + FLUSH_SPARE calls, each
    after a read through ``flush`` whose operations (``skip``) mark the
    calls apart, so that a call the trace cut short is left out."""
    def body():
        flush.sum()
        fn()

    calls, cur = [], None
    for e in device_events(body, reps + FLUSH_SPARE):
        if e.name in skip:          # a read is several operations
            if cur:
                calls.append(cur)
            cur = {}
        elif cur is not None:
            c, d = cur.get(e.name, (0, 0.0))
            cur[e.name] = (c + 1, d + e.time_range.end - e.time_range.start)
    calls = (calls + ([cur] if cur else []))[-reps:]
    check(len(calls) == reps, f"{len(calls)} of {reps} calls traced")
    out = {}
    for call in calls:
        for name, (c, d) in call.items():
            oc, od = out.get(name, (0, 0.0))
            out[name] = (oc + c, od + d)
    return {name: (c / reps, d / c) for name, (c, d) in out.items()}


def block_ops(dev, ml, rng, flush, skip):
    """The elasticity cycle's block work on its fine level, by its torch
    operations: one ``bspmv``, one block Gauss-Seidel color pass (a full
    ``bspmv``, the batched product with the inverted diagonal blocks and
    the masked update) and the level's whole pre-smoothing sweep.  Prints
    each one's device time per call (L2-warm), its time with the host, and
    its device operations (``ops_per_call``, L2 flushed)."""
    import torch
    from pyamg_tpu_torch.ops.spmv import bspmv
    from pyamg_tpu_torch.relaxation import relaxation as rx
    from pyamg_tpu_torch.relaxation.smoothing import apply_smoother
    lvl = ml.levels[0]
    A = lvl.A
    kind, sopts, params = lvl.pre
    x, b = (torch.as_tensor(rng.standard_normal(A.shape[0]),
                            device=dev).float() for _ in range(2))
    first = params["colors"] == 0
    cases = [("bspmv", lambda: bspmv(A, x)),
             ("block GS color pass",
              lambda: x + params["omega"] * rx._block_update(
                  A, x, b, params["Dinv"], first)),
             (f"block GS {sopts['sweep']} sweep ({sopts['ncolors']} colors)",
              lambda: apply_smoother(kind, sopts, params, A, x, b))]
    for what, fn in cases:
        fn()
        torch.cuda.synchronize()
        ops = "; ".join(
            f"{c:g} x {us:.2f} us {name[:70]}" for name, (c, us) in
            sorted(ops_per_call(fn, flush, skip).items(),
                   key=lambda kv: -kv[1][0] * kv[1][1]))
        print(f"sa_more: elasticity A0 {what}: {device_ms(fn) * 1e3:.2f} us "
              f"of device time per call, {cuda_ms(fn, reps=50) * 1e3:.2f} us "
              f"per call with the host; device operations per call (L2 "
              f"flushed before each): {ops}")


def sa_more_phase(dev, sms, rng, flush, skip, want=None, small=None,
                  n_aniso=512, n_el=100, n_small=(64, 24), reps=5):
    """The ``sa_more:`` phase: build both SA paths and print their setup
    and hierarchy; gate the hierarchies against ``want`` (JAX_SA) before
    any solve; hold K1 on every anisotropic DIA level and K2 (each level's
    symmetric sweep, omega 1) on every level it smooths against the plain
    versions; drive each path; time the elasticity path's block work
    (``block_ops``, with ``flush`` and ``skip`` as ``flushed_ms``); then
    solve both at ``n_small`` on ``dev`` and on the CPU: the iterations of
    ``small`` (JAX_SA_SMALL) on both and solutions within 1e-9.  Returns
    ({path: kernel inputs}, {path: launches per operator})."""
    want = JAX_SA if want is None else want
    small = JAX_SA_SMALL if small is None else small
    paths = sa_more_paths(dev, n_aniso, n_el)
    inputs, per_ops = {}, {}
    for path in paths:
        tag, ml = path["name"], path["ml"]
        got = sa_more_describe(ml)
        print(f"sa_more: {tag} setup {path['setup_s']:.3f} s, by key "
              f"{ {k: round(v, 4) for k, v in path['by_key'].items()} }, "
              f"levels {len(got['rows'])} rows {got['rows']} blocksizes "
              f"{got['blocksizes']} operator_complexity "
              f"{got['operator_complexity']!r} layout {got['layouts']} DIA "
              f"diagonals {got['dia']}")
        ref = want[tag]
        check(got["rows"] == ref["rows"] and
              got["blocksizes"] == ref["blocksizes"],
              f"{tag}: rows {got['rows']} blocksizes {got['blocksizes']}, "
              f"the JAX package {ref['rows']} {ref['blocksizes']}")
        check(abs(got["operator_complexity"] - ref["operator_complexity"])
              <= 1e-6, f"{tag}: operator complexity off the JAX package's")
        check(got["layouts"] == ref["layouts"] and got["dia"] == ref["dia"],
              f"{tag}: layouts or DIA widths differ from the JAX package's")
        inputs[tag] = path_kernels(dev, path, rng, sms, phase="sa_more",
                                   coarsest=True)
    for path in paths:
        _, per_ops[path["name"]], _ = drive_path(
            path, want[path["name"]], reps, phase="sa_more")
    block_ops(dev, paths[1]["ml"], rng, flush, skip)
    # the same small solves on the card and on the CPU (plain versions)
    got = {}
    for d in ("cuda", "cpu"):
        got[d] = []
        for p in sa_more_paths(d, *n_small):
            it = {}
            x = p["ml"].solve_refined(p["b"], A_fine=p["S"], tol=1e-10,
                                      iterations_out=it, **p["kw"])
            got[d].append((x, it))
    for p, (xc, itc), (xh, ith) in zip(paths, got["cuda"], got["cpu"]):
        ref = small[p["name"]]
        diff = float(np.linalg.norm(xc - xh) / np.linalg.norm(xh))
        print(f"sa_more: {p['name']} small solve, card {itc} CPU {ith} (JAX "
              f"package {ref['outer']} {list(ref['inner'])}), card vs CPU "
              f"relative difference {diff:.3e} (tol 1e-9)")
        check(itc == ith and iterations_near(itc, ref),
              f"{p['name']}: the small solve's iterations differ between "
              f"card and CPU or from the JAX package's")
        check(diff < 1e-9, f"{p['name']}: the card's small solve disagrees "
                           f"with the CPU's")
    return inputs, per_ops


def gate_hierarchy(phase, path, ref):
    """Print a path's setup time by key and its hierarchy, and check it
    against the JAX package's ``ref``: rows, operator complexity within
    1e-6, layouts, DIA widths and SELL plans."""
    tag = path["name"]
    got = classical_describe(path["ml"])
    print(f"{phase}: {tag} setup {path['setup_s']:.3f} s, by key "
          f"{ {k: round(v, 4) for k, v in path['by_key'].items()} }, "
          f"levels {len(got['rows'])} rows {got['rows']} "
          f"operator_complexity {got['operator_complexity']!r} (JAX "
          f"package {ref['operator_complexity']!r}) layout "
          f"{got['layouts']} DIA diagonals {got['dia']} SELL plans "
          f"{got['plans']}")
    check(got["rows"] == ref["rows"],
          f"{tag}: rows {got['rows']}, the JAX package {ref['rows']}")
    check(abs(got["operator_complexity"] - ref["operator_complexity"])
          <= 1e-6, f"{tag}: operator complexity off the JAX package's")
    check(got["layouts"] == ref["layouts"] and got["dia"] == ref["dia"]
          and got["plans"] == ref["plans"],
          f"{tag}: layouts, DIA widths or plans differ from the JAX "
          f"package's")


def families_paths(dev, n=500):
    """The ``families:`` phase's paths on 2-D Poisson n^2, built with the
    port's entry points and their defaults, compressed and placed on
    ``dev``: root-node SA in float64 (``solve_refined(accel="cg")``),
    pairwise aggregation in float32 and adaptive SA with one candidate in
    float64 (both ``inner_maxiter=60, max_outer=20``); ``max_coarse=50``,
    b from ``default_rng(0)``.  Each a dict as ``classical_paths`` gives;
    adaptive SA's also holds ``work`` and its trials, root-node SA's
    ``sell32``: float32 SELL plans of its P0 and R0 (placed) with their
    host ELLs, which the path's float64 transfers are not."""
    from pyamg_tpu_torch.aggregation import (adaptive_sa_solver,
                                             pairwise_solver, rootnode_solver)
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    from pyamg_tpu_torch.sparse.sell import sell_from_ell
    dia2 = ("dia_spmv", "dia_gs_sweep")
    capped = {"accel": "cg", "inner_maxiter": SA_INNER_CAP, "max_outer": 20}
    A64 = poisson((n, n))
    S = to_scipy(A64).tocsr()
    b = np.random.default_rng(0).standard_normal(A64.shape[0])
    specs = [
        ("RN", np.float64, lambda A: rootnode_solver(A, max_coarse=50),
         {"accel": "cg"}, dia2),
        ("PW", np.float32, lambda A: pairwise_solver(A, max_coarse=50),
         capped, dia2 + ("sell_spmv", "sell_gs_sweep")),
        ("aSA", np.float64, lambda A: adaptive_sa_solver(
            A, num_candidates=1, max_coarse=50), capped, dia2)]
    out = []
    for name, dtype, make, kw, must in specs:
        t0 = time.perf_counter()
        ml = make(A64.astype(dtype))
        setup = time.perf_counter() - t0
        path = {"name": name, "S": S, "b": b, "kw": kw, "setup_s": setup,
                "must": must}
        if isinstance(ml, tuple):
            ml, path["work"] = ml
            path["trials"] = ml.trials
        path["by_key"] = ml.setup_timings()
        if name == "RN":
            path["sell32"] = {}
            for attr in "PR":
                ell = getattr(ml.levels[0], attr).astype(np.float32)
                plan = sell_from_ell(ell)
                check(plan is not None, f"no float32 SELL plan of RN {attr}0")
                path["sell32"][f"{attr}0"] = (plan.to(dev), ell)
        ml.compress_stencils()
        ml.to_device(dev)
        path["ml"] = ml
        out.append(path)
    return out


def families_phase(dev, sms, rng, want=None, small=None, n=500, n_small=48,
                   reps=5):
    """The ``families:`` phase: build the three paths and print their setup
    and hierarchy (and adaptive SA's trials and work); gate them against
    ``want`` (JAX_FAMILIES) before any solve; hold every kernel case on
    their operators against the plain versions (``path_kernels``, K1 and
    K2 in each level's dtype) and K3 on root-node's float32 P0 and R0
    plans; drive each path; then solve all three at ``n_small`` on ``dev``
    and on the CPU: the iterations of ``small`` (JAX_FAMILIES_SMALL) on
    both and solutions within 1e-9.  Returns ({path: kernel inputs},
    {path: launches per operator})."""
    import torch
    from pyamg_tpu_torch.ops import sell_kernels as sk
    want = JAX_FAMILIES if want is None else want
    small = JAX_FAMILIES_SMALL if small is None else small
    paths = families_paths(dev, n)
    inputs, per_ops = {}, {}
    for path in paths:
        tag, ml = path["name"], path["ml"]
        ref = want[tag]
        gate_hierarchy("families", path, ref)
        if "trials" in path:
            trials = [(t["rows"], t["rho"]) for t in path["trials"]]
            for k, ((rows, rho), (rrows, rrho)) in enumerate(
                    zip(trials, ref["trials"])):
                print(f"families: {tag} trial {k}: rows {rows} rho {rho!r} "
                      f"(JAX package {rrows} {rrho!r})")
            print(f"families: {tag} work {path['work']!r} (JAX package "
                  f"{ref['work']!r})")
            check(len(trials) == len(ref["trials"]) and
                  all(r == rr and (rho is None) == (rrho is None) and
                      (rho is None or abs(rho - rrho) <= 1e-8 * rrho)
                      for (r, rho), (rr, rrho) in zip(trials, ref["trials"]))
                  and path["work"] == ref["work"],
                  f"{tag}: trials or work differ from the JAX package's")
        inputs[tag] = path_kernels(dev, path, rng, sms, phase="families",
                                   coarsest=True)
    # K3 on root-node's float32 plans of P0 and R0 (off the path)
    for name, (S, ell) in paths[0]["sell32"].items():
        x = torch.as_tensor(rng.standard_normal(S.shape[1]),
                            device=dev).float()
        y, want_y = sk.sell_spmv(S, x), sk.sell_spmv_plain(S, x)
        torch.cuda.synchronize()
        err, _ = rel_err(y, want_y)
        print(f"families: K3 RN {name} float32 plan (off the path) "
              f"{S.kind}/{S.t} {S.shape} passes {S.n_passes} K={S.K} "
              f"Sy={S.Sy} {sk.spmv_geometry(S.n_passes, S.shape[0])} "
              f"max_abs_err={err:.3e}")
        check(err == 0, f"K3 RN {name} float32 plan disagrees with its plain "
                        f"version")
        inputs["RN"][f"K3 {name} float32"] = (S, ell, x, err)
    for path in paths:
        _, per_ops[path["name"]], _ = drive_path(
            path, want[path["name"]], reps, phase="families")
    # the same small solves on the card and on the CPU (plain versions)
    got = {}
    for d in ("cuda", "cpu"):
        got[d] = []
        for p in families_paths(d, n_small):
            it = {}
            x = p["ml"].solve_refined(p["b"], A_fine=p["S"], tol=1e-10,
                                      iterations_out=it, **p["kw"])
            got[d].append((x, it, classical_describe(p["ml"])))
    for p, (xc, itc, dc), (xh, ith, _) in zip(paths, got["cuda"],
                                              got["cpu"]):
        ref = small[p["name"]]
        diff = float(np.linalg.norm(xc - xh) / np.linalg.norm(xh))
        print(f"families: {p['name']} {n_small}^2 rows {dc['rows']} "
              f"operator_complexity {dc['operator_complexity']!r}, solve on "
              f"the card {itc} CPU {ith} (JAX package {ref['outer']} "
              f"{list(ref['inner'])}), card vs CPU relative difference "
              f"{diff:.3e} (tol 1e-9)")
        check(dc["rows"] == ref["rows"] and
              abs(dc["operator_complexity"] - ref["operator_complexity"])
              <= 1e-6, f"{p['name']}: the small hierarchy differs from the "
                       f"JAX package's")
        check(itc == ith and iterations_near(itc, ref),
              f"{p['name']}: the small solve's iterations differ between "
              f"card and CPU or from the JAX package's")
        check(diff < 1e-9, f"{p['name']}: the card's small solve disagrees "
                           f"with the CPU's")
    return inputs, per_ops


def cg_near(it, want):
    """The blackbox solve's CG count within 1 of the JAX package's."""
    return abs(it["cg"] - want["cg"]) <= 1


def blackbox_paths(dev, n=500):
    """The ``blackbox:`` phase's paths on 2-D Poisson n^2, b from
    ``default_rng(0).random``, built on the host with the port's entry
    points and placed on ``dev``: BB, the hierarchy of
    ``solver(A, solver_configuration(A))`` in float64, compressed, solved
    by the blackbox's reuse route ``solve(A, b, tol=1e-10,
    existing_solver=ml)`` (CG); LL, smoothed aggregation with Lloyd
    aggregation and ``max_coarse=50`` in float32, compressed; SZ, smoothed
    aggregation with strength-based Schwarz smoothing, ``keep=True`` and
    ``max_coarse=50`` in float32, not compressed (Schwarz takes ELL
    levels).  LL and SZ are solved by ``solve_refined(tol=1e-10,
    accel="cg", inner_maxiter=60, max_outer=20)``.  Each a dict as
    ``classical_paths`` gives; BB's with its own ``solve`` and iteration
    rule."""
    from pyamg_tpu_torch import solve, solver, solver_configuration
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    A64 = poisson((n, n))
    A32 = A64.astype(np.float32)
    S = to_scipy(A64).tocsr()
    b = np.random.default_rng(0).random(A64.shape[0])
    schwarz = ("strength_based_schwarz", {})
    capped = {"accel": "cg", "inner_maxiter": SA_INNER_CAP, "max_outer": 20}
    specs = [
        ("BB", lambda: solver(A64, solver_configuration(A64, verb=False)),
         True, ("dia_spmv", "dia_gs_sweep")),
        ("LL", lambda: smoothed_aggregation_solver(
            A32, aggregate=("lloyd", {}), max_coarse=50), True,
         ("dia_spmv", "dia_gs_sweep", "sell_spmv", "sell_gs_sweep")),
        ("SZ", lambda: smoothed_aggregation_solver(
            A32, max_coarse=50, keep=True, presmoother=schwarz,
            postsmoother=schwarz), False, ())]
    out = []
    for name, make, compress, must in specs:
        t0 = time.perf_counter()
        ml = make()
        setup = time.perf_counter() - t0
        path = {"name": name, "S": S, "b": b, "kw": capped, "A": A64,
                "setup_s": setup, "by_key": ml.setup_timings(),
                "must": must}
        if compress:
            ml.compress_stencils()
        path["ml"] = ml.to_device(dev)
        if name == "BB":
            def bb_solve(residuals=None, iterations_out=None, ml=ml):
                res = [] if residuals is None else residuals
                x = solve(A64, b, tol=1e-10, existing_solver=ml, verb=False,
                          residuals=res, device=dev)
                if iterations_out is not None:
                    iterations_out["cg"] = len(res) - 1
                return x.cpu().numpy()
            path.update(solve=bb_solve,
                        iterations_ok=(cg_near, "within 1 of its CG count"))
        out.append(path)
    return out


def cycle_profile(path, rng):
    """One V-cycle of the path's hierarchy from zero, profiled warm: it
    must read nothing on the host.  Prints its wall, busy time, device
    operations and host syncs."""
    import torch
    ml = path["ml"]
    A0 = ml.levels[0].A
    M = ml.aspreconditioner()
    r = torch.as_tensor(rng.standard_normal(A0.shape[0]),
                        device=ml.device).to(A0.dtype)
    M.matvec(r)
    torch.cuda.synchronize()
    wall, busy, ops, syncs = profiled(lambda: M.matvec(r))
    print_profile(f"{path['name']} one V-cycle", wall, busy, ops, syncs,
                  top=6, phase="blackbox")
    check(syncs == 0, f"{path['name']}: a cycle read the host {syncs} times")


def schwarz_refuses_compressed(dev, n):
    """SZ's hierarchy at n^2, compressed (its fine level becomes a DIA) and
    placed: a Schwarz cycle raises the port's TypeError, where the JAX
    package's stops with an AttributeError."""
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    schwarz = ("strength_based_schwarz", {})
    ml = smoothed_aggregation_solver(
        poisson((n, n)).astype(np.float32), max_coarse=50, keep=True,
        presmoother=schwarz, postsmoother=schwarz).compress_stencils()
    ml.to_device(dev)
    try:
        ml.solve(np.ones(n * n), maxiter=1)
    except TypeError as e:
        print(f"blackbox: SZ {n}^2 compressed ({type(ml.levels[0].A).__name__}"
              f" fine level): a Schwarz cycle raises TypeError: {e}")
        check("uncompressed (ELL) hierarchy" in str(e),
              f"SZ: the TypeError does not say what Schwarz takes: {e}")
        return
    check(False, "SZ: a Schwarz cycle on a compressed hierarchy did not "
                 "raise")


def blackbox_phase(dev, sms, rng, want=None, small=None, n=500, n_small=48,
                   reps=5):
    """The ``blackbox:`` phase: build BB, LL and SZ and print their setup
    by key and hierarchy; gate them against ``want`` (JAX_BLACKBOX) before
    any solve; hold every K1/K2/K3/K5 case on their operators against the
    plain versions (K1 and K2 in the level's dtype); drive each path
    (``drive_path``: SZ must launch no kernel), profile one V-cycle of
    each (no host read) and check that CG warns on SZ's non-symmetric
    smoothing; then, at ``n_small`` on ``dev`` and on the CPU, solve all
    three as above and BB once more fresh to 1e-8 (uncompressed): the
    hierarchies and iterations of ``small`` (JAX_BLACKBOX_SMALL) on both
    and solutions within 1e-9, and a compressed Schwarz hierarchy raises
    the port's TypeError.  Returns ({path: kernel inputs}, {path:
    launches per operator})."""
    import warnings
    from pyamg_tpu_torch import solve
    want = JAX_BLACKBOX if want is None else want
    small = JAX_BLACKBOX_SMALL if small is None else small
    paths = blackbox_paths(dev, n)
    inputs, per_ops = {}, {}
    for path in paths:
        gate_hierarchy("blackbox", path, want[path["name"]])
        inputs[path["name"]] = path_kernels(dev, path, rng, sms,
                                            phase="blackbox")
    for path in paths:
        _, per_ops[path["name"]], _ = drive_path(
            path, want[path["name"]], reps, phase="blackbox")
        cycle_profile(path, rng)
    sz = paths[2]["ml"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sz.solve(np.ones(sz.levels[0].A.shape[0]), accel="cg", maxiter=1)
    check(any("non-symmetric" in str(w.message) for w in caught),
          "SZ: CG did not warn of its non-symmetric preconditioner")
    print("blackbox: SZ CG warns: Incompatible non-symmetric multigrid "
          "preconditioner, as the JAX package does")
    schwarz_refuses_compressed(dev, n_small)
    # the same small solves on the card and on the CPU (plain versions)
    got = {}
    for d in ("cuda", "cpu"):
        got[d] = []
        for p in blackbox_paths(d, n_small):
            it = {}
            x = p.get("solve", lambda **kw: p["ml"].solve_refined(
                p["b"], A_fine=p["S"], tol=1e-10, **p["kw"], **kw))(
                    iterations_out=it)
            got[d].append((x, it, classical_describe(p["ml"])))
            if p["name"] == "BB":
                res = []
                xf = solve(p["A"], p["b"], tol=1e-8, verb=False,
                           residuals=res, device=d).cpu().numpy()
                got[d].append((xf, {"cg": len(res) - 1}, None))
    refs = {"BB": {"cg": small["BB"]["cg"]},
            "BB fresh to 1e-8": {"cg": small["BB"]["cg_fresh"]},
            "LL": {k: small["LL"][k] for k in ("outer", "inner")},
            "SZ": {k: small["SZ"][k] for k in ("outer", "inner")}}
    for name, (xc, itc, dc), (xh, ith, _) in zip(refs, got["cuda"],
                                                  got["cpu"]):
        ref, ref_it = small[name.split()[0]], refs[name]
        diff = float(np.linalg.norm(xc - xh) / np.linalg.norm(xh))
        print(f"blackbox: {name} {n_small}^2 "
              + (f"rows {dc['rows']} operator_complexity "
                 f"{dc['operator_complexity']!r}, " if dc else "")
              + f"solve on the card {itc} CPU {ith} (JAX package {ref_it}), "
              f"card vs CPU relative difference {diff:.3e} (tol 1e-9)")
        if dc:
            check(dc["rows"] == ref["rows"] and
                  abs(dc["operator_complexity"] - ref["operator_complexity"])
                  <= 1e-6, f"{name}: the small hierarchy differs from the "
                           f"JAX package's")
        ok = cg_near(itc, ref_it) if "cg" in ref_it else \
            iterations_near(itc, ref_it)
        check(itc == ith and ok, f"{name}: the small solve's iterations "
                                 f"differ between card and CPU or from the "
                                 f"JAX package's")
        check(diff < 1e-9, f"{name}: the card's small solve disagrees with "
                           f"the CPU's")
    return inputs, per_ops


def dia_rows(dev, sms, row, inputs, per_ops, k1_ops, k2_ops):
    """The kernel table's rows of K1 on the (path, operator) pairs
    ``k1_ops`` and of K2 on ``k2_ops``, from a phase's kernel inputs
    (``path_kernels``) and launches per operator (``drive_path``); K1's
    library call is torch.sparse's CSR product of the same operator, in
    its dtype; the bound counts the dtype's bytes and operations at its
    rate."""
    import torch
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.sparse.matrix import DIA, to_scipy

    def sized(D):
        es = D.data.element_size()
        dt = "" if es == 4 else f", {str(D.data.dtype)[6:]}"
        return es, (F32_FLOPS if es == 4 else F64_FLOPS), dt

    rows = []
    for tag, op in k1_ops:
        D, xk, err1 = inputs[tag][f"K1 {op}"]
        n, nd = D.shape[0], len(D.offsets)
        es, peak, dt = sized(D)
        Acsr = csr_on(to_scipy(DIA(D.data.cpu().numpy(), D.offsets,
                                   D.shape)), dev, D.data.dtype)
        e_lib, scale = rel_err(Acsr @ xk,
                               dk.dia_spmv_plain(D.data, D.offsets, n, xk))
        check(e_lib <= 1e-5 * scale,
              f"library CSR product disagrees ({tag} {op})")
        g = dk.spmv_geometry(n, 1, D.data.shape[1], es, sms)
        rows.append(row(
            f"dia_spmv {tag} {op}{dt}", "pyamg_tpu/ops/pallas_kernels.py:52",
            per_ops[tag]["dia_spmv"][op], err1,
            lambda: dk.dia_spmv(D.data, D.offsets, n, xk),
            lambda: dk.dia_spmv_plain(D.data, D.offsets, n, xk),
            lambda: Acsr @ xk, (nd * n + 2 * n) * es, 2 * nd * n, peak=peak,
            tag=f"dia_spmv {tag} {op} ({nd} diagonals{dt}, {g})"))
    for tag, op in k2_ops:
        D, xg, bg, Dinv, colors, order, err2 = inputs[tag][f"K2 {op}"]
        n, nd = D.shape[0], len(D.offsets)
        es, peak, dt = sized(D)
        per_color = torch.bincount(colors.long()).tolist()
        g = dk.gs_geometry(n, nd, max(abs(o) for o in D.offsets), es, sms)
        rows.append(row(
            f"dia_gs_sweep {tag} {op}{dt}",
            "pyamg_tpu/ops/pallas_kernels.py:126",
            per_ops[tag]["dia_gs_sweep"][op], err2,
            lambda: dk.dia_gs_sweep(D.data, D.offsets, n, xg, bg, Dinv,
                                    colors, order),
            lambda: dk.dia_gs_sweep_plain(D.data, D.offsets, n, xg, bg, Dinv,
                                          colors, order, 1.0),
            # the band, b, Dinv and x read once, x written once; colors
            None, (nd * n + 4 * n) * es + 4 * n,
            sum(per_color[c] for c in order) * (2 * nd + 3), peak=peak,
            tag=f"dia_gs_sweep {tag} {op} ({len(order)} passes{dt}, {g})"))
    return rows


def parallel_build(n, cfg, dev, mesh=None, spmv="gspmd"):
    """(A, ml): the port's float64 SA hierarchy of 2-D Poisson n^2 with
    ``cfg``'s ``max_coarse``, sharded over ``mesh`` (``spmv``) or, with no
    mesh, placed on ``dev`` whole."""
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.parallel import shard_hierarchy
    A = poisson((n, n))
    ml = smoothed_aggregation_solver(A, max_coarse=cfg["max_coarse"])
    if mesh is None:
        return A, ml.to_device(dev)
    return A, shard_hierarchy(ml, mesh,
                              replicate_below=cfg["replicate_below"],
                              spmv=spmv)


def gate_history(tag, got, want, rtol):
    """A residual history entry by entry within ``rtol`` of ``want``."""
    err = max((abs(g - w) / abs(w) for g, w in zip(got, want)), default=0.0)
    print(f"parallel: {tag} residuals {got} (want {want}), max relative "
          f"difference {err:.3e} (tol {rtol:g})")
    check(len(got) == len(want) and err <= rtol,
          f"{tag}: residual history off by {err:.3e} (tol {rtol:g})")


def kernel_launches():
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import sell_kernels as sk
    return {k.__name__: k.launches for k in dk.KERNELS + sk.KERNELS}


def reset_kernel_launches():
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import sell_kernels as sk
    dk.reset_launch_counts()
    sk.reset_launch_counts()


def led_in_ops(fn, dev):
    """The device operations [(name, start, end)] of one call of ``fn``,
    traced after TRACE_LEAD_IN one-element additions on ``dev``: a trace
    taken late in the script loses its first few operations (three of a
    500^2 gspmd solve's all-gathers, in every retake), and then it loses
    these instead."""
    import torch
    pad = torch.zeros(1, device=dev)

    def body():
        for _ in range(TRACE_LEAD_IN):
            pad.add_(1)
        fn()

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in device_events(body, 1)]


def nccl_kernels(ops):
    """{collective: NCCL device operations} among a trace's device
    operations (``nccl:_all_gather_base`` is an all-gather)."""
    out = {}
    for name, _, _ in ops:
        low = name.lower().replace("_", "")
        if "nccl" not in low:
            continue
        kind = "all_gather" if "allgather" in low else \
            "all_reduce" if "allreduce" in low else name[:60]
        out[kind] = out.get(kind, 0) + 1
    return out


def parallel_flows(dev, mesh, n, want, reps=5, timed=False):
    """The dryrun's flows at n^2 on a hierarchy sharded over ``mesh``
    against the JAX package's (``want``): the levels; CG for 3 iterations
    and 2 standalone cycles on the gspmd path and 2 cycles on the halo
    path, each history to ``want['rtol']`` and to the unsharded port's in
    this call; the halo CG to 1e-8 within 1 of the JAX package's
    iterations and a true relative residual below 1e-8; no K1-K5 launch
    around the sharded solves.  With ``timed``: for gspmd, halo and the
    unsharded hierarchy, the warm median of ``reps`` CGs to 1e-8, one
    profiled, and the collectives per solve.  Returns the hierarchies."""
    import torch
    from pyamg_tpu_torch.parallel import partition
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    tag = f"{n}^2"
    t0 = time.perf_counter()
    A, ml0 = parallel_build(n, want, dev)
    _, mlg = parallel_build(n, want, dev, mesh)
    _, mlh = parallel_build(n, want, dev, mesh, spmv="halo")
    print(f"parallel: {tag} setup of three float64 hierarchies (unsharded, "
          f"gspmd, halo) {time.perf_counter() - t0:.2f} s")
    S = to_scipy(A)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rtol = want["rtol"]
    for name, ml in (("gspmd", mlg), ("halo", mlh)):
        rows = [int(l.A.shape[0]) for l in ml.levels]
        sharded = [i for i, l in enumerate(ml.levels)
                   if isinstance(l.A, partition.RowSharded)]
        print(f"parallel: {tag} {name} levels {rows}, sharded {sharded}, "
              f"A {[type(l.A).__name__ for l in ml.levels]}, P/R in-split "
              f"{[(getattr(l.P, 'in_sharded', None), getattr(l.R, 'in_sharded', None)) for l in ml.levels]}")
        check(rows == want["rows"] and sharded == want["sharded"],
              f"{tag} {name}: levels {rows} sharded {sharded}, the JAX "
              f"package's {want['rows']} {want['sharded']}")

    def run(ml, **kw):
        res = []
        x = ml.solve(b, residuals=res, **kw)
        return res, x

    cg3 = dict(maxiter=3, tol=1e-12, accel="cg")
    sa2 = dict(maxiter=2, tol=1e-12)
    cg8 = dict(maxiter=100, tol=1e-8, accel="cg")
    un = {k: run(ml0, **kw)[0] for k, kw in (("cg3", cg3), ("sa2", sa2))}
    reset_kernel_launches()
    got = {"cg3": run(mlg, **cg3), "sa2": run(mlg, **sa2),
           "halo2": run(mlh, **sa2)}
    res8, x8 = run(mlh, **cg8)
    launched = kernel_launches()
    for key, (res, x) in got.items():
        gate_history(f"{tag} {key}", res, want[key], rtol)
        gate_history(f"{tag} {key} against the unsharded port", res,
                     un["sa2" if key == "halo2" else key], rtol)
        check(x.shape == (A.shape[0],) and bool(torch.isfinite(x).all()),
              f"{tag} {key}: x is not a finite vector of the fine size")
    relres = float(np.linalg.norm(b - S @ x8.cpu().numpy())
                   / np.linalg.norm(b))
    it8 = len(res8) - 1
    print(f"parallel: {tag} halo CG to 1e-8: {it8} iterations (JAX package "
          f"{want['halo_cg_iters']}), true relative residual {relres:.3e}; "
          f"kernel launches around the sharded solves {launched}")
    check(abs(it8 - want["halo_cg_iters"]) <= 1 and relres < 1e-8,
          f"{tag} halo CG: {it8} iterations, relres {relres:.3e}")
    check(all(v == 0 for v in launched.values()),
          f"{tag}: a CUDA kernel launched on the sharded path: {launched}")
    if not timed:
        return ml0, mlg, mlh
    for name, ml in (("unsharded", ml0), ("gspmd", mlg), ("halo", mlh)):
        def solve(ml=ml):
            return ml.solve(b, **cg8)
        solve()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        partition.reset_counts()
        reset_kernel_launches()
        solve()
        per_solve = dict(partition.COUNTS)
        launched = kernel_launches()
        print(f"parallel: {tag} {name} CG to 1e-8 warm median of {reps} "
              f"{statistics.median(walls) * 1e3:.3f} ms (all "
              f"{[round(w * 1e3, 3) for w in walls]}), collectives per "
              f"solve {per_solve}, kernel launches {launched}")
        check(all(v == 0 for v in launched.values()),
              f"{tag} {name}: a CUDA kernel launched: {launched}")
        wall, busy, ops, syncs = profiled(solve)
        print_profile(f"{tag} {name} CG to 1e-8", wall, busy, ops, syncs,
                      top=8, phase="parallel")
        nccl = nccl_kernels(led_in_ops(solve, mesh.device))
        print(f"parallel: {tag} {name} NCCL device operations in a trace of "
              f"one solve led in by {TRACE_LEAD_IN} small operations {nccl} "
              f"(collectives {per_solve})")
        check(all(v == per_solve[kind] for kind, v in nccl.items()
                  if kind in per_solve),
              f"{tag} {name}: the NCCL device operations {nccl} do not "
              f"match the collectives {per_solve}")
        if name != "unsharded":
            M = ml.aspreconditioner()
            r = ml._scatter(b, torch.float64)
            M.matvec(r)
            wall, busy, ops, syncs = profiled(lambda: M.matvec(r))
            print_profile(f"{tag} {name} one V-cycle", wall, busy, ops,
                          syncs, top=4, phase="parallel")
            check(syncs == 0, f"{tag} {name}: a sharded cycle read the "
                              f"host {syncs} times")
    return ml0, mlg, mlh


def collective_costs(mesh, n, reps=200):
    """Host microseconds a call (host clock around ``reps`` calls, then one
    synchronize) of the port's collective wrappers on ``mesh``: an
    all-gather of an (n,) float64 vector and an all-reduce of one scalar,
    beside a plain copy of the same vector (one torch operation)."""
    import torch
    from pyamg_tpu_torch.parallel import partition
    x = torch.ones(n, dtype=torch.float64, device=mesh.device)
    s = torch.ones((), dtype=torch.float64, device=mesh.device)
    out = {}
    for name, fn in (("all_gather", lambda: partition.all_gather(x, mesh)),
                     ("all_reduce", lambda: partition.all_reduce(s, mesh)),
                     ("copy", lambda: x.clone())):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    print(f"parallel: host us a call over {reps} calls (n = {n}, float64): "
          + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def emulate_halo(plan, x):
    """Every rank's halo step of ``plan`` in one process: rank e's send
    buffer for offset o feeds rank (e + o) % p, which concatenates what it
    receives in offset order; the ranks' rows laid end to end."""
    import torch
    from pyamg_tpu_torch.parallel.halo import halo_local_mv, halo_send
    p, dev = plan.ndev, x.device
    xt = x.reshape(p, plan.m_loc)
    sends = [halo_send(xt[e], [torch.as_tensor(s[e], device=dev).long()
                               for s in plan.send_idx]) for e in range(p)]
    ys = []
    for d in range(p):
        segs = [sends[(d - o) % p][k] for k, o in enumerate(plan.offsets)]
        ys.append(halo_local_mv(
            torch.as_tensor(plan.cols[d], device=dev).long(),
            torch.as_tensor(plan.vals[d], device=dev), xt[d], segs))
    return torch.cat(ys)


def emulated_steps(dev, ml, ranks=(4, 8)):
    """Each rank's step at ``ranks`` ranks, emulated in one process on
    ``dev``: the halo product of A0, A1 and A2 (``build_halo_plan``, A1
    padded) and the ``ShardedELL`` product of P0 and R0 on the gathered
    input, laid end to end, against the unsharded product on ``dev``: 0
    expected (rows are independent and keep their slots' order), gated at
    1e-14 of the largest entry."""
    import torch
    from pyamg_tpu_torch.ops.spmv import spmv
    from pyamg_tpu_torch.parallel import partition as pt
    from pyamg_tpu_torch.parallel.halo import build_halo_plan
    rng = np.random.default_rng(3)
    lv = ml.levels
    for p in ranks:
        for name, A in (("A0", lv[0].A), ("A1", lv[1].A), ("A2", lv[2].A),
                        ("P0", lv[0].P), ("R0", lv[0].R)):
            n, m = A.shape
            x = torch.as_tensor(rng.standard_normal(m), device=dev)
            want = spmv(A.to(dev), x)
            if name[0] == "A":
                plan = build_halo_plan(A, p)
                xp = torch.zeros(plan.shape[1], dtype=x.dtype, device=dev)
                xp[:m] = x
                got = emulate_halo(plan, xp)[:n]
                how = (f"halo offsets {plan.offsets} segments "
                       f"{plan.seg_sizes}")
            else:
                Ap = pt.pad_matrix_rows(A, p, identity_pad=False)
                xp = torch.zeros(m + (-m) % p, dtype=x.dtype, device=dev)
                xp[:m] = x
                got = torch.cat([pt.shard_matrix(Ap, pt.RowMesh(
                    None, p, r, dev, tuple(range(p))), in_sharded=False).mv(xp)
                    for r in range(p)])[:n]
                how = "gathered input"
            err, scale = rel_err(got, want)
            print(f"parallel: emulated {p} ranks {name} ({n} x {m}, {how}) "
                  f"against the unsharded product: max_abs_err {err:.3e} "
                  f"(largest entry {scale:.3e}){'' if err == 0 else ' NOT bit for bit'}")
            check(got.shape == want.shape and err <= 1e-14 * scale,
                  f"emulated {p} ranks {name}: off by {err:.3e}")


def parallel_phase(dev, backend="nccl", sizes=(32, 500), want=None, reps=5):
    """The ``parallel:`` phase: a one-rank process group (NCCL on the
    card; no other backend there) on ``dev``; the dryrun's flows at
    ``sizes[0]`` and at ``sizes[1]`` (timed), against ``want``
    (JAX_PARALLEL); and each rank's step at 4 and 8 ranks, emulated on
    ``dev`` at ``sizes[1]``; the host cost of the collectives
    (``collective_costs``).  The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from pyamg_tpu_torch.parallel import make_row_mesh
    want = JAX_PARALLEL if want is None else want
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        kw = {"device_id": dev}
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)
    try:
        mesh = make_row_mesh(1, device=dev)
        print(f"parallel: one-rank {dist.get_backend()} group on "
              f"{mesh.device}; its exchanges carry nothing, so the card "
              f"measures the sharded wrappers' own cost")
        small, full = sizes
        parallel_flows(dev, mesh, small, want[small], reps)
        ml0, _, _ = parallel_flows(dev, mesh, full, want[full], reps,
                                   timed=True)
        collective_costs(mesh, want[full]["rows"][0])
    finally:
        dist.destroy_process_group()
    emulated_steps(dev, ml0)


def main():
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import ds as dsm
    from pyamg_tpu_torch.ops import sell_kernels as sk
    from pyamg_tpu_torch.sparse import sell as sellm
    from pyamg_tpu_torch.relaxation.relaxation import (dinv_vec, gs_order,
                                                       make_coloring)
    from pyamg_tpu_torch.sparse.matrix import (DIA, DIA_TILE, dia_from_ell,
                                               to_scipy)
    from pyamg_tpu_torch.gallery import poisson

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    for name, built in build_kernels().items():
        print(f"device: {name} build {built['seconds']:.1f} s -> "
              f"{built['path']}")
        for kname, regs, smem, frame, st, ld in ptxas_report(built["log"]):
            print(f"device: ptxas {name} {kname}: {regs} registers, {smem} "
                  f"bytes static shared memory, stack frame {frame} B, spill "
                  f"stores {st} B, spill loads {ld} B")
    print(f"device: kernels built in {time.perf_counter() - t0:.1f} s")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # -- 2. kernels against their plain versions ---------------------------
    _, ml_k, _ = build_hierarchy(500, 0, dev, ds=False)
    t0 = time.perf_counter()
    _, ml_s = build_sa3d(64)
    ml_s.to_device(dev)
    print(f"kernels: 64^3 setup+compress+place {time.perf_counter() - t0:.2f}"
          f" s")
    kernel_inputs = {}
    k1_capacity = dk._lib().spmv_capacity

    def k1_case(name, band, offsets, n, dtype, cols=1, x=None):
        """K1 once against its plain version to 0 (non-finite at the same
        places), one launch: (data, x, error)."""
        data = band if isinstance(band, torch.Tensor) else \
            torch.as_tensor(np.asarray(band), device=dev)
        data = data.to(dtype)
        shape = (n,) if cols == 1 else (n, cols)
        if x is None:
            x = torch.as_tensor(rng.standard_normal(shape),
                                device=dev).to(dtype)
        before = dk.dia_spmv.launches
        y = dk.dia_spmv(data, offsets, n, x)
        launched = dk.dia_spmv.launches - before
        want = dk.dia_spmv_plain(data, offsets, n, x)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        err = float((y[fin] - want[fin]).abs().max())
        same = same_non_finite(y, want)
        g = dk.spmv_geometry(n, cols, data.shape[1], data.element_size(),
                             sms)
        print(f"kernels: K1 {name} {str(dtype)[6:]} x {tuple(x.shape)} "
              f"ndiag={len(offsets)} npad={data.shape[1]} {g} launches "
              f"{launched} non-finite {int((~fin).sum())} same places "
              f"{same} max_abs_err={err:.3e}")
        check(y.shape == want.shape and same and err == 0 and launched == 1,
              f"K1 {name} {dtype} disagrees with its plain version or took "
              f"{launched} launches")
        return data, x, err

    P2048 = poisson((2048, 2048)).astype(np.float32)
    big = dia_from_ell(P2048)
    k1_ops = {"500^2 level 0": ml_k.levels[0].A,
              "500^2 level 1": ml_k.levels[1].A,
              "64^3 A0": ml_s.levels[0].A, "2048^2": big}
    for name, D in k1_ops.items():
        for dtype in (torch.float32, torch.float64):
            data, x, err = k1_case(name, D.data, D.offsets, D.shape[0],
                                   dtype)
            if dtype == torch.float32:
                kernel_inputs[f"K1 {name}"] = (D, data, x, err)
            if name == "500^2 level 0":
                k1_case(f"{name}, x with inf and NaN", data, D.offsets,
                        D.shape[0], dtype, x=non_finite(x))
    D = ml_k.levels[0].A
    n = D.shape[0]
    for cols in (2, 3):
        k1_case("500^2 level 0", D.data, D.offsets, n, torch.float32, cols)
    xo = torch.as_tensor(rng.standard_normal(n + 1), device=dev).float()
    k1_case("500^2 level 0, x off a 16-byte boundary", D.data, D.offsets, n,
            torch.float32, x=xo[1:])
    # 80 diagonals, and more than the launch takes by value (the offsets
    # from device memory)
    wide = tuple(sorted(rng.choice(np.arange(-3000, 3001), 80,
                                   replace=False).tolist()))
    wider = tuple(sorted(rng.choice(np.arange(-30_000, 30_001),
                                    k1_capacity + 1, replace=False).tolist()))
    wider_band = rng.standard_normal((len(wider), 8_192), dtype=np.float32)
    for dtype in (torch.float32, torch.float64):
        k1_case("80 diagonals", rng.standard_normal((80, 250_000)), wide,
                250_000, dtype)
        k1_case(f"{len(wider)} diagonals, past the {k1_capacity} by value",
                wider_band, wider, 8_000, dtype)
        # npad not a multiple of 4, n not a multiple of the rows a thread
        k1_case("npad 250,001, n 249,999", rng.standard_normal((5, 250_001)),
                D.offsets, 249_999, dtype)
        k1_case("one-sided band", rng.standard_normal((4, 262_144)),
                (-1500, -40, -1, 0), 262_144, dtype)

    def dia_level(lvl):
        """(DIA, colors, ncolors, Dinv) of a level's presmoother."""
        _, sopts, params = lvl.pre
        return lvl.A, params["colors"], sopts["ncolors"], params["Dinv"]

    colors_b, nc_b = make_coloring(P2048)
    k2_ops = {"500^2 level 0": dia_level(ml_k.levels[0]),
              "500^2 level 1": dia_level(ml_k.levels[1]),
              "64^3 A0": dia_level(ml_s.levels[0]),
              "2048^2": (big, colors_b, nc_b, dinv_vec(P2048))}

    def k2_case(name, D, colors, nc, Dinv):
        """K2 symmetric, omega 1 and 0.8, float32 and float64, on an x
        holding inf and NaN and on a 2-column x, each against the plain
        version to 0: (DIA, data, x, b, Dinv, colors, order, error) of
        float32, omega 1."""
        n, nd = D.shape[0], len(D.offsets)
        col = torch.as_tensor(colors, device=dev)
        halo = max(abs(o) for o in D.offsets)
        first = None
        for dtype in (torch.float32, torch.float64):
            data = torch.as_tensor(D.data, device=dev).to(dtype)
            Di = torch.as_tensor(Dinv, device=dev).to(dtype)
            x = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            b = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            print(f"kernels: K2 {name} {str(dtype)[6:]} n={n} ndiag={nd} "
                  f"{dk.gs_geometry(n, nd, halo, data.element_size(), sms)}")
            for omega in (1.0, 0.8):
                order = gs_order(nc, "symmetric", 1, omega)
                got = dk.dia_gs_sweep(data, D.offsets, n, x, b, Di, col,
                                      order, omega)
                want = dk.dia_gs_sweep_plain(data, D.offsets, n, x, b, Di,
                                             col, order, omega)
                torch.cuda.synchronize()
                err, _ = rel_err(got, want)
                print(f"kernels: K2 {name} {str(dtype)[6:]} omega={omega} "
                      f"order={order} max_abs_err={err:.3e}")
                check(err == 0, f"K2 {name} {dtype} omega={omega} disagrees "
                                f"with its plain version")
                if first is None:
                    first = (D, data, x, b, Di, col, order, err)
            order = gs_order(nc, "symmetric", 1, 1.0)
            xn = non_finite(x)
            got = dk.dia_gs_sweep(data, D.offsets, n, xn, b, Di, col, order)
            want = dk.dia_gs_sweep_plain(data, D.offsets, n, xn, b, Di, col,
                                         order, 1.0)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max())
            print(f"kernels: K2 {name} {str(dtype)[6:]} x with inf and NaN: "
                  f"{int((~fin).sum())} non-finite, same places "
                  f"{same_non_finite(got, want)}, max_abs_err={err:.3e}")
            check(same_non_finite(got, want) and err == 0,
                  f"K2 {name} {dtype} disagrees with its plain version on an "
                  f"x holding inf and NaN")
        _, data, _, _, Di, _, order, _ = first
        x2 = torch.as_tensor(rng.standard_normal((n, 2)), device=dev).float()
        b2 = torch.as_tensor(rng.standard_normal((n, 2)), device=dev).float()
        got = dk.dia_gs_sweep(data, D.offsets, n, x2, b2, Di, col, order)
        want = dk.dia_gs_sweep_plain(data, D.offsets, n, x2, b2, Di, col,
                                     order, 1.0)
        torch.cuda.synchronize()
        err, _ = rel_err(got, want)
        print(f"kernels: K2 {name} float32 x {tuple(x2.shape)} "
              f"max_abs_err={err:.3e}")
        check(got.shape == (n, 2) and err == 0,
              f"K2 {name} disagrees with its plain version on a 2-column x")
        return first

    for name, op in k2_ops.items():
        kernel_inputs[f"K2 {name}"] = k2_case(name, *op)

    def k2_pairs(name, D, colors, nc, Dinv, pairs):
        """K2 for each (omega, sweep) of ``pairs`` in float32 and float64
        against the plain version to 0, with its launch shape."""
        n = D.shape[0]
        col = torch.as_tensor(colors, device=dev)
        halo = max(abs(o) for o in D.offsets)
        for dtype in (torch.float32, torch.float64):
            data = torch.as_tensor(D.data, device=dev).to(dtype)
            Di = torch.as_tensor(Dinv, device=dev).to(dtype)
            x = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            b = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            g = dk.gs_geometry(n, len(D.offsets), halo, data.element_size(),
                               sms)
            for omega, sweep in pairs:
                order = gs_order(nc, sweep, 1, omega)
                got = dk.dia_gs_sweep(data, D.offsets, n, x, b, Di, col,
                                      order, omega)
                want = dk.dia_gs_sweep_plain(data, D.offsets, n, x, b, Di,
                                             col, order, omega)
                torch.cuda.synchronize()
                err, _ = rel_err(got, want)
                print(f"kernels: K2 {name} {str(dtype)[6:]} n={n} "
                      f"omega={omega} sweep={sweep} order={order} {g} "
                      f"max_abs_err={err:.3e}")
                check(err == 0, f"K2 {name} {dtype} omega={omega} {sweep} "
                                f"disagrees with its plain version")

    # the (omega, sweep) pairs of the solvers phase: SOR symmetric with
    # omega 1.2 on the 500^2 levels (S2, float64), forward and backward on
    # 64^3 A0 (S6, float32); each pair on each operator in both dtypes
    for name in ("500^2 level 0", "500^2 level 1", "64^3 A0"):
        k2_pairs(name, *k2_ops[name], SOLVER_K2_PAIRS)

    # the solvers phase's uncollapsed float64 500^2 hierarchies run K1 and
    # K2 on the small DIA levels below the main path's dense tail too: K1
    # in both dtypes and K2 symmetric with omega 1 (GS) and 1.2 (S2's SOR)
    _, ml_k64, _ = build_hierarchy(500, 0, dev, ds=False, dtype=np.float64)
    for i in range(2, len(ml_k64.levels) - 1):
        D = ml_k64.levels[i].A
        check(isinstance(D, DIA), f"500^2 float64 level {i} is not a DIA")
        for dtype in (torch.float32, torch.float64):
            k1_case(f"500^2 float64 level {i}", D.data, D.offsets,
                    D.shape[0], dtype)
        k2_pairs(f"500^2 float64 level {i}", *dia_level(ml_k64.levels[i]),
                 ((1.0, "symmetric"), (1.2, "symmetric")))
    del ml_k64

    def random_band(n, offsets, scale):
        """(DIA, colors, 4, Dinv): random entries times ``scale`` on
        ``offsets``, 4 on the main diagonal, 4 random colors."""
        data = np.zeros((len(offsets), -(-n // DIA_TILE) * DIA_TILE),
                        np.float32)
        data[:, :n] = rng.standard_normal((len(offsets), n)) * scale
        data[offsets.index(0), :n] = 4.0
        return (DIA(data, tuple(offsets), (n, n)),
                rng.integers(0, 4, n).astype(np.int32), 4,
                np.full(n, 0.25, np.float32))

    # K2 in the staged regime on a one-sided band (a block waits for blocks
    # that do not read its rows) and on 80 diagonals (the kernel for any
    # width), 7 and 8 passes
    wide80 = sorted({0, *rng.choice(np.arange(-250, 251), 79,
                                    replace=False).tolist()})
    while len(wide80) < 80:
        wide80 = sorted({*wide80, int(rng.integers(-250, 251))})
    for name, op in (("one-sided band",
                      random_band(262_144, [-1500, -40, -1, 0], 1.0)),
                     ("80 diagonals", random_band(30_000, wide80, 0.02))):
        D, n = op[0], op[0].shape[0]
        halo = max(abs(o) for o in D.offsets)
        check(all(dk.gs_geometry(n, len(D.offsets), halo, item, sms).staged
                  for item in (4, 8)),
              f"K2's {name} case is not in the staged regime")
        k2_case(name, *op)

    a = torch.as_tensor(rng.standard_normal(1 << 20), device=dev).float()
    c = torch.as_tensor(rng.standard_normal(1 << 20), device=dev).float()
    p, e = dsm.two_prod(a, c)
    exact = p.double() + e.double() == a.double() * c.double()
    print(f"kernels: two_prod exact on {int(exact.sum())}/{exact.numel()}")
    check(bool(exact.all()), "double-single two_prod is not exact on the "
                             "card (a fused multiply-add crept in)")

    # K3 on every SELL operator of the 64^3 path, K5 on its square levels
    sell_ops = sell_operators(ml_s)
    check(sorted(sell_ops) == sorted(SELL_64),
          f"SELL operators {sorted(sell_ops)} at 64^3")
    for name, (S, _) in sell_ops.items():
        x = torch.as_tensor(rng.standard_normal(S.shape[1]),
                            device=dev).float()
        y = sk.sell_spmv(S, x)
        want = sk.sell_spmv_plain(S, x)
        xn = non_finite(x)
        yn, wantn = sk.sell_spmv(S, xn), sk.sell_spmv_plain(S, xn)
        torch.cuda.synchronize()
        err, scale = rel_err(y, want)
        tol = 1e-6 * scale
        fin = torch.isfinite(wantn)
        errn = float((yn[fin] - wantn[fin]).abs().max())
        print(f"kernels: K3 {name} {S.kind}/{S.t} {S.shape} passes "
              f"{S.n_passes} K={S.K} Sy={S.Sy} "
              f"{sk.spmv_geometry(S.n_passes, S.shape[0])} "
              f"max_abs_err={err:.3e} tol={tol:.3e}; x with inf and NaN: "
              f"{int((~fin).sum())} non-finite, same places "
              f"{same_non_finite(yn, wantn)}, max_abs_err={errn:.3e}")
        check(err <= tol, f"K3 {name} disagrees with its plain version")
        check(same_non_finite(yn, wantn) and errn <= tol,
              f"K3 {name} disagrees with its plain version on an x holding "
              f"inf and NaN")
        kernel_inputs[f"K3 {name}"] = (S, x, err)

    t0 = time.perf_counter()
    big_s = sellm.sell_from_ell(poisson((1800, 1800)).astype(np.float32))
    t_plan = time.perf_counter() - t0
    check(big_s is not None and big_s.square and
          big_s.x_rows * sellm.LANE * 4 > sellm._VMEM_X_BUDGET,
          "the 1800^2 plan is not a square SELL in the K4 regime")
    big_sd = big_s.to(dev)
    x = torch.as_tensor(rng.standard_normal(big_s.shape[1]),
                        device=dev).float()
    y = sk.sell_spmv(big_sd, x)
    want = sk.sell_spmv_plain(big_sd, x)
    torch.cuda.synchronize()
    err, scale = rel_err(y, want)
    print(f"kernels: K4 regime 1800^2 plan {t_plan:.2f} s, passes "
          f"{big_s.n_passes} K={big_s.K} Sy={big_s.Sy}, x "
          f"{big_s.x_rows * sellm.LANE * 4 / 2**20:.1f} MiB in the "
          f"reference's layout (VMEM budget "
          f"{sellm._VMEM_X_BUDGET / 2**20:.0f} MiB) max_abs_err={err:.3e} "
          f"tol={1e-6 * scale:.3e}")
    check(err <= 1e-6 * scale, "K3 in the K4 regime disagrees with its "
                               "plain version")
    kernel_inputs["K4"] = (big_sd, big_s, x, err)

    def k5_case(name, S, Dinv, nonfinite):
        """K5 forward, backward and symmetric, omega 1 and 0.8, against the
        plain version (and, with ``nonfinite``, forward and backward on an
        x holding inf and NaN): (S, x, b, Dinv, error of forward, omega 1)."""
        n = S.shape[0]
        x = torch.as_tensor(rng.standard_normal(n), device=dev).float()
        b = torch.as_tensor(rng.standard_normal(n), device=dev).float()
        print(f"kernels: K5 {name} n={n} passes {S.n_passes} "
              f"{sk.gs_geometry(S.n_passes, S.Sy * sellm.LANE)}")
        first = None
        for sweep in ("forward", "backward", "symmetric"):
            for omega in (1.0, 0.8):
                got = sk.sell_gs_sweep(S, x, b, Dinv, omega, sweep)
                want = sk.sell_gs_sweep_plain(S, x, b, Dinv, omega, sweep)
                torch.cuda.synchronize()
                err, scale = rel_err(got, want)
                tol = 1e-5 * scale
                print(f"kernels: K5 {name} {sweep} omega={omega} "
                      f"max_abs_err={err:.3e} tol={tol:.3e}")
                check(err <= tol, f"K5 {name} {sweep} disagrees with its "
                                  f"plain version")
                first = err if first is None else first
        for sweep in ("forward", "backward") if nonfinite else ():
            xn = non_finite(x)
            got = sk.sell_gs_sweep(S, xn, b, Dinv, 1.0, sweep)
            want = sk.sell_gs_sweep_plain(S, xn, b, Dinv, 1.0, sweep)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max()) if fin.any() \
                else 0.0
            print(f"kernels: K5 {name} {sweep} x with inf and NaN: "
                  f"{int((~fin).sum())} non-finite, same places "
                  f"{same_non_finite(got, want)}, max_abs_err={err:.3e}")
            check(same_non_finite(got, want) and
                  err <= 1e-5 * float(want[fin].abs().max()),
                  f"K5 {name} {sweep} disagrees with its plain version on "
                  f"an x holding inf and NaN")
        return S, x, b, Dinv, first

    for name in ("A1", "A2"):
        S, _ = sell_ops[name]
        Dinv = ml_s.levels[int(name[1])].pre[2]["Dinv"]
        kernel_inputs[f"K5 {name}"] = k5_case(name, S, Dinv, True)

    # the (omega, sweep) pairs of the solvers phase (S6: SOR forward before
    # and backward after, omega 1.2) on A1 and A2, to 0
    for name in ("A1", "A2"):
        S, _ = sell_ops[name]
        Dinv = ml_s.levels[int(name[1])].pre[2]["Dinv"]
        x = torch.as_tensor(rng.standard_normal(S.shape[0]),
                            device=dev).float()
        b = torch.as_tensor(rng.standard_normal(S.shape[0]),
                            device=dev).float()
        for omega, sweep in SOLVER_K5_PAIRS:
            got = sk.sell_gs_sweep(S, x, b, Dinv, omega, sweep)
            want = sk.sell_gs_sweep_plain(S, x, b, Dinv, omega, sweep)
            torch.cuda.synchronize()
            err, _ = rel_err(got, want)
            print(f"kernels: K5 {name} {sweep} omega={omega} "
                  f"max_abs_err={err:.3e}")
            check(err == 0, f"K5 {name} {sweep} omega={omega} disagrees "
                            f"with its plain version")

    # K5 where x does not fit in shared memory, off the main path
    k5_case("1800^2 (off the main path)", big_sd, 1.0 / big_sd.diag, False)

    def k2_per_level(hier, tag):
        """{level: (K2 launches, color passes, passes a sweep)} of the DIA
        levels of ``hier`` from the counters of the last solve; fails
        unless every DIA level ran and each launch ran one whole sweep."""
        out = {}
        for i, lvl in enumerate(hier.levels):
            if not isinstance(lvl.A, DIA) or lvl.pre[0] != "gauss_seidel":
                continue
            key = (lvl.A.shape[0], len(lvl.A.offsets))
            per = {len(gs_order(so["ncolors"], so["sweep"], so["iterations"],
                                so["omega"])) for _, so, _ in (lvl.pre,
                                                               lvl.post)}
            out[f"{tag} level {i}"] = (dk.dia_gs_sweep.by_op[key],
                                       dk.dia_gs_sweep.passes[key],
                                       per.pop() if len(per) == 1 else None)
        check(out and all(l > 0 and (k is None or p == l * k)
                          for l, p, k in out.values()) and
              sum(l for l, _, _ in out.values()) ==
              dk.dia_gs_sweep.launches,
              f"K2 at {tag} is not one launch per sweep on every DIA level")
        return out

    def k1_per_level(hier, tag):
        """{level: K1 launches} of the DIA levels of ``hier`` from the
        counters of the last solve (keyed by operator, as the wrapper
        counts); fails unless every DIA level but the coarsest (solved
        directly) ran K1 and the levels add up to the kernel's total."""
        out = {f"{tag} level {i}": dk.dia_spmv.by_op[(lvl.A.shape[0],
                                                      len(lvl.A.offsets))]
               for i, lvl in enumerate(hier.levels) if isinstance(lvl.A, DIA)}
        last = f"{tag} level {len(hier.levels) - 1}"
        check(out and all(v > 0 for k, v in out.items() if k != last) and
              sum(out.values()) == dk.dia_spmv.launches,
              f"K1 at {tag} did not run on every DIA level, or its launches "
              f"per level do not add up to its total")
        return out

    # -- 3. main path --------------------------------------------------------
    dk.reset_launch_counts()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    A64, ml, (nlev_setup, oc) = build_hierarchy(500, 4096, dev)
    ml.to_device(dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    b = np.random.default_rng(SEED).standard_normal(A64.shape[0])
    it, res = {}, []
    t0 = time.perf_counter()
    x = ml.solve_refined_device(b, tol=1e-10, inner_tol=1e-5,
                                inner_maxiter=30, max_outer=10,
                                residuals=res, iterations_out=it)
    t_cold = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in dk.KERNELS}
    As = to_scipy(A64)
    relres = float(np.linalg.norm(b - As @ x) / np.linalg.norm(b))
    print(f"main: setup+prep {t_setup:.2f} s, cold solve {t_cold:.3f} s")
    print(f"main: levels {nlev_setup} active {len(ml.levels)} "
          f"operator_complexity {oc:.6f} outer {it['outer']} "
          f"inner {it['inner']} true_relres {relres:.3e} "
          f"residuals {res} launches {launches}")
    check(x.shape == (A64.shape[0],) and np.isfinite(x).all(),
          "x is not a finite vector of the right shape")
    check(nlev_setup == 6 and len(ml.levels) == 3,
          "expected 6 levels, 3 active")
    check(abs(oc - 1.2244) <= 1e-3, "operator complexity off 1.2244")
    check(it["outer"] == 2 and abs(it["inner"] - 12) <= 1,
          "expected 2 outer and 12 +- 1 inner iterations")
    check(relres < 1e-10, "true relative residual not below 1e-10")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")
    k2_500 = k2_per_level(ml, "500^2")
    k1_500 = k1_per_level(ml, "500^2")
    print(f"main: K1 launches per solve {launches['dia_spmv']}, per DIA "
          f"level {k1_500}; K2 launches per solve "
          f"{launches['dia_gs_sweep']}, per DIA level (launches, color "
          f"passes, passes a sweep) {k2_500}")

    # the same small solve on the card and on the CPU (plain versions)
    xs = {}
    for d in ("cuda", "cpu"):
        A64s, mls, _ = build_hierarchy(96, 600, d)
        mls.to_device(d)
        bs = np.random.default_rng(SEED).standard_normal(A64s.shape[0])
        xs[d] = mls.solve_refined_device(bs)
    diff = float(np.linalg.norm(xs["cuda"] - xs["cpu"]) /
                 np.linalg.norm(xs["cpu"]))
    print(f"main: 96^2 solve, card vs CPU relative difference {diff:.3e} "
          f"(tol 1e-9)")
    check(diff < 1e-9, "the card's solve disagrees with the CPU's")

    # -- 4. sa3d: 3-D Poisson 64^3, standard SA, SELL ----------------------
    t0 = time.perf_counter()
    A3, ml3 = build_sa3d(64)
    nlev3, oc3 = len(ml3.levels), ml3.operator_complexity()
    ml3.to_device(dev)
    torch.cuda.synchronize()
    t_setup3 = time.perf_counter() - t0
    lay = layout(ml3)
    plans = {k: (S.kind, S.t, S.n_passes, S.Sy)
             for k, (S, _) in sell_operators(ml3).items()}
    print(f"sa3d: setup+compress+place {t_setup3:.2f} s, levels {nlev3} "
          f"operator_complexity {oc3:.7f} layout {lay} plans {plans}")
    check(nlev3 == 4, "expected 4 levels at 64^3")
    check(abs(oc3 - 1.5504) <= 1e-3, "operator complexity off 1.5504")
    check(lay == LAYOUT_64 and plans == SELL_64,
          "the 64^3 layouts differ from the reference's")
    S3 = to_scipy(A3)
    b3 = np.random.default_rng(0).standard_normal(A3.shape[0])
    dk.reset_launch_counts()
    sk.reset_launch_counts()
    it3, res3 = {}, []
    t0 = time.perf_counter()
    x3 = ml3.solve_refined(b3, A_fine=S3, tol=1e-10, accel="cg",
                           residuals=res3, iterations_out=it3)
    t_cold3 = time.perf_counter() - t0
    launches3 = {k.__name__: k.launches for k in dk.KERNELS + sk.KERNELS}
    relres3 = float(np.linalg.norm(b3 - S3 @ x3) / np.linalg.norm(b3))
    print(f"sa3d: cold solve_refined {t_cold3:.3f} s, outer {it3['outer']} "
          f"inner {it3['inner']} (JAX package {list(JAX_INNER_64)}) "
          f"true_relres {relres3:.3e} residuals {res3} launches "
          f"{launches3}")
    check(x3.shape == (A3.shape[0],) and np.isfinite(x3).all(),
          "x is not a finite vector of the right shape")
    check(it3["outer"] == 2, "expected 2 outer iterations")
    check(len(it3["inner"]) == len(JAX_INNER_64) and
          all(abs(a - b) <= 1 for a, b in zip(it3["inner"], JAX_INNER_64)),
          "inner CG iterations differ from the JAX package's by more than 1")
    check(relres3 < 1e-10, "true relative residual not below 1e-10")
    check(all(v > 0 for v in launches3.values()),
          "a kernel of the 64^3 path was never launched")
    # the same launches per operator (keyed by plan, as the wrappers count)
    ops3 = sell_operators(ml3)
    per_op3 = {k.__name__: {name: k.by_plan[sk.plan_key(S)]
                            for name, (S, _) in ops3.items()
                            if k is sk.sell_spmv or S.square}
               for k in sk.KERNELS}
    k2_64 = k2_per_level(ml3, "64^3")
    k1_64 = k1_per_level(ml3, "64^3")
    print(f"sa3d: launches per operator {per_op3}; K1 launches per solve "
          f"{launches3['dia_spmv']}, per DIA level {k1_64}; K2 launches per "
          f"solve {launches3['dia_gs_sweep']}, per DIA level (launches, "
          f"color passes, passes a sweep) {k2_64}")
    check(all(v > 0 for d in per_op3.values() for v in d.values()) and
          all(sum(per_op3[k.__name__].values()) == k.launches
              for k in sk.KERNELS),
          "a SELL operator of the 64^3 path was never launched, or the "
          "per-operator counts do not add up to the kernels' totals")

    # the same small solve on the card and on the CPU (plain versions)
    xs = {}
    for d in ("cuda", "cpu"):
        A24, ml24 = build_sa3d(24)
        ml24.to_device(d)
        b24 = np.random.default_rng(0).standard_normal(A24.shape[0])
        xs[d] = ml24.solve_refined(b24, A_fine=to_scipy(A24), tol=1e-10)
    diff = float(np.linalg.norm(xs["cuda"] - xs["cpu"]) /
                 np.linalg.norm(xs["cpu"]))
    print(f"sa3d: 24^3 solve, card vs CPU relative difference {diff:.3e} "
          f"(tol 1e-9)")
    check(diff < 1e-9, "the card's 24^3 solve disagrees with the CPU's")

    # -- 5. times -------------------------------------------------------------
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ml.solve_refined_device(b)
        walls.append(time.perf_counter() - t0)
    print_profile("500^2", *profiled(lambda: ml.solve_refined_device(b)))

    cyc = ml._make_cycle("V")
    rv = torch.as_tensor(rng.standard_normal(A64.shape[0]),
                         device=dev).float()

    def vcycle():
        return cyc(torch.zeros_like(rv), rv)

    print(f"times: warm solve median of 5 "
          f"{statistics.median(walls) * 1e3:.3f} ms (all "
          f"{[round(w * 1e3, 3) for w in walls]}); V-cycle "
          f"{cuda_ms(vcycle, reps=50):.4f} ms per call, "
          f"{device_ms(vcycle, reps=10):.4f} ms of device time")

    # read before each timed kernel call, so that the call reads its inputs
    # from device memory as the bound assumes (5x the 50 MB L2)
    flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
    skip = flush_ops(flush)

    row = functools.partial(kernel_row, flush, skip)

    # K1 on each DIA operator, launches per solve from each path's cold
    # solve (2048^2 is off both paths); the library call is torch.sparse's
    # CSR product of the same operator
    k1_launches = {"500^2 level 0": k1_500["500^2 level 0"],
                   "500^2 level 1": k1_500["500^2 level 1"],
                   "64^3 A0": k1_64["64^3 level 0"], "2048^2": 0}
    rows = []
    for name in k1_ops:
        D, data, xk, err1 = kernel_inputs[f"K1 {name}"]
        n, nd = D.shape[0], len(D.offsets)
        Acsr = csr_on(to_scipy(DIA(data.cpu().numpy(), D.offsets, D.shape)),
                      dev)
        e_lib, scale = rel_err(Acsr @ xk,
                               dk.dia_spmv_plain(data, D.offsets, n, xk))
        check(e_lib <= 1e-5 * scale, f"library CSR product disagrees ({name})")
        g = dk.spmv_geometry(n, 1, data.shape[1], 4, sms)
        off_path = name == "2048^2"
        rows.append(row(
            f"dia_spmv {name}" + (" (off the main path)" if off_path else ""),
            "pyamg_tpu/ops/pallas_kernels.py:52", k1_launches[name], err1,
            lambda: dk.dia_spmv(data, D.offsets, n, xk),
            lambda: dk.dia_spmv_plain(data, D.offsets, n, xk),
            lambda: Acsr @ xk,
            # the band's rows, x read once and y written once
            (nd * n + 2 * n) * 4, 2 * nd * n,
            plain_reps=5 if off_path else 50,
            tag=f"dia_spmv {name} ({nd} diagonals, {g})"))

    # K2 on each DIA operator, launches per solve from each path's cold
    # solve (2048^2 is off both paths)
    k2_launches = {"500^2 level 0": k2_500["500^2 level 0"][0],
                   "500^2 level 1": k2_500["500^2 level 1"][0],
                   "64^3 A0": k2_64["64^3 level 0"][0], "2048^2": 0}
    for name in k2_ops:
        D, data, xg, bg, Dinv, colors, order, err2 = \
            kernel_inputs[f"K2 {name}"]
        n, nd = D.shape[0], len(D.offsets)
        # each pass updates only the rows of its color: 2 flops per stored
        # diagonal and 3 for the update
        per_color = torch.bincount(colors.long()).tolist()
        off_path = name == "2048^2"
        g = dk.gs_geometry(n, nd, max(abs(o) for o in D.offsets), 4, sms)
        rows.append(row(
            f"dia_gs_sweep {name}" + (" (off the main path)" if off_path
                                      else ""),
            "pyamg_tpu/ops/pallas_kernels.py:126", k2_launches[name], err2,
            lambda: dk.dia_gs_sweep(data, D.offsets, n, xg, bg, Dinv, colors,
                                    order),
            lambda: dk.dia_gs_sweep_plain(data, D.offsets, n, xg, bg, Dinv,
                                          colors, order, 1.0),
            None,
            # each input (data, b, Dinv, colors, x) read once, x written once
            (nd * n + 4 * n) * 4 + 4 * n,
            sum(per_color[c] for c in order) * (2 * nd + 3),
            plain_reps=5 if off_path else 50,
            tag=f"dia_gs_sweep {name} ({len(order)} passes, {g})"))

    # the 64^3 path: warm solves, one profiled, then K3-K5 at its shapes
    walls3 = []
    for _ in range(5):
        t0 = time.perf_counter()
        ml3.solve_refined(b3, A_fine=S3, tol=1e-10, accel="cg")
        walls3.append(time.perf_counter() - t0)
    print(f"times: 64^3 warm solve_refined median of 5 "
          f"{statistics.median(walls3) * 1e3:.3f} ms (all "
          f"{[round(w * 1e3, 3) for w in walls3]})")
    print_profile("64^3", *profiled(lambda: ml3.solve_refined(
        b3, A_fine=S3, tol=1e-10, accel="cg")), top=16)

    sell_src = "pyamg_tpu_torch/csrc/sell_kernels.cu"

    def slot_model(S, vectors_bytes, tag):
        """Print the bytes of the plan's padded slots beside the bound."""
        T, Sy, _ = S.vals.shape
        nbytes = T * Sy * sellm.LANE * 8 + vectors_bytes
        print(f"times: {tag} plan-slot byte model ({T * Sy * sellm.LANE} "
              f"slots for {S.nnz} stored entries): "
              f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us ({nbytes / 1e6:.2f} "
              f"MB)")

    def sell_row(name, replaces, S, S_scipy, x, err, tag, launches):
        """K3/K4 at one operator: bound from its stored entries (value and
        column each), x read and y written; 2 flops per stored entry."""
        lib = csr_on(S_scipy, dev)
        e_lib, scale = rel_err(lib @ x, sk.sell_spmv_plain(S, x))
        check(e_lib <= 1e-5 * scale, f"library CSR product disagrees ({tag})")
        vectors = (S.shape[0] + S.shape[1]) * 4
        r = row(name, replaces, launches, err, lambda: sk.sell_spmv(S, x),
                lambda: sk.sell_spmv_plain(S, x), lambda: lib @ x,
                S.nnz * 8 + vectors, 2 * S.nnz, source=sell_src,
                plain_reps=5, tag=tag)
        slot_model(S, vectors, tag)
        return r

    for name, (S, S_host) in sell_operators(ml_s).items():
        _, x, err = kernel_inputs[f"K3 {name}"]
        rows.append(sell_row(
            f"sell_spmv {name}", "pyamg_tpu/ops/sell_kernels.py:29", S,
            to_scipy(S_host), x, err, f"sell_spmv {name}",
            per_op3["sell_spmv"][name]))
    # no square SELL past the TPU's 6 MB budget runs on either main path
    big_sd, big_s, xk4, err4 = kernel_inputs["K4"]
    rows.append(sell_row(
        "sell_spmv (K4 regime, 2-D Poisson 1800^2, off the main path)",
        "pyamg_tpu/ops/sell_kernels.py:108", big_sd,
        sellm.sell_to_scipy(big_s), xk4, err4, "sell_spmv K4 regime 1800^2",
        0))

    for name in ("A1", "A2"):
        S, xg, bg, Dinv, err5 = kernel_inputs[f"K5 {name}"]
        n = S.shape[0]
        tag = f"sell_gs_sweep {name} forward"
        # one directional sweep reads the stored entries, b, Dinv and x
        # once and writes x; 2 flops per stored entry and 3 per row for the
        # update
        rows.append(row(
            tag, "pyamg_tpu/ops/sell_kernels.py:241",
            per_op3["sell_gs_sweep"][name], err5,
            lambda: sk.sell_gs_sweep(S, xg, bg, Dinv, 1.0, "forward"),
            lambda: sk.sell_gs_sweep_plain(S, xg, bg, Dinv, 1.0, "forward"),
            None, S.nnz * 8 + 4 * n * 4, 2 * S.nnz + 3 * n,
            source=sell_src, plain_reps=2, tag=tag))
        slot_model(S, 4 * n * 4, tag)

    # -- 6. solvers: the rest of the solve phase -----------------------------
    t0 = time.perf_counter()
    paths = solver_paths(dev)
    print(f"solvers: setup+compress+place of the six paths "
          f"{time.perf_counter() - t0:.2f} s")
    solver_launches = solvers_phase(dev, paths, JAX_SOLVERS,
                                    JAX_S1_TRUE_RELRES)
    print(f"solvers: launches per solve {solver_launches}")
    del paths

    # -- 7. classical: Ruge-Stuben 500^2 and AIR 256^2 ----------------------
    t0 = time.perf_counter()
    cinputs, cper_op = classical_phase(dev, sms, rng)
    print(f"classical: phase before its times {time.perf_counter() - t0:.2f}"
          f" s")
    rows += dia_rows(dev, sms, row, cinputs, cper_op,
                     (("RS", "A1"), ("RS", "A2"), ("AIR", "A0")),
                     (("RS", "A1"), ("RS", "A2")))
    for tag, op in (("RS", "P0"), ("RS", "R0"), ("RS", "A3"), ("AIR", "R0"),
                    ("AIR", "A1")):
        S, S_host, xk, err3 = cinputs[tag][f"K3 {op}"]
        rows.append(sell_row(
            f"sell_spmv {tag} {op}", "pyamg_tpu/ops/sell_kernels.py:29", S,
            to_scipy(S_host), xk, err3, f"sell_spmv {tag} {op}",
            cper_op[tag]["sell_spmv"][op]))
    S, xg, bg, Dinv, err5 = cinputs["RS"]["K5 A3"]
    n = S.shape[0]
    tag = "sell_gs_sweep RS A3 forward"
    rows.append(row(
        tag, "pyamg_tpu/ops/sell_kernels.py:241",
        cper_op["RS"]["sell_gs_sweep"]["A3"], err5,
        lambda: sk.sell_gs_sweep(S, xg, bg, Dinv, 1.0, "forward"),
        lambda: sk.sell_gs_sweep_plain(S, xg, bg, Dinv, 1.0, "forward"),
        None, S.nnz * 8 + 4 * n * 4, 2 * S.nnz + 3 * n, source=sell_src,
        plain_reps=2, tag=tag))
    slot_model(S, 4 * n * 4, tag)
    del cinputs

    # -- 8. sa_more: anisotropic diffusion 512^2 and elasticity 100^2 -------
    t0 = time.perf_counter()
    sinputs, sper_op = sa_more_phase(dev, sms, rng, flush, skip)
    print(f"sa_more: phase before its times {time.perf_counter() - t0:.2f} s")
    # K1 and K2 on the anisotropic finest level and on A3 (361 rows, the
    # small-level regime)
    aniso = (("anisotropic", "A0"), ("anisotropic", "A3"))
    rows += dia_rows(dev, sms, row, sinputs, sper_op, aniso, aniso)
    del sinputs

    # -- 9. families: root-node, pairwise and adaptive SA on 500^2 ----------
    t0 = time.perf_counter()
    finputs, fper_op = families_phase(dev, sms, rng)
    print(f"families: phase before its times {time.perf_counter() - t0:.2f}"
          f" s")
    # K1 and K2 on root-node A0, A1 and A4 (float64) and pairwise A6 (51
    # diagonals, float32)
    fam = (("RN", "A0"), ("RN", "A1"), ("RN", "A4"), ("PW", "A6"))
    rows += dia_rows(dev, sms, row, finputs, fper_op, fam, fam)
    # K3 on pairwise P0 and R1 (the path's transfers; its R0 stays ELL, as
    # in the JAX package) and on root-node's float32 P0 and R0 plans (off
    # the path, whose float64 transfers stay ELL)
    k3 = [("PW", "P0", fper_op["PW"]["sell_spmv"]["P0"]),
          ("PW", "R1", fper_op["PW"]["sell_spmv"]["R1"]),
          ("RN", "P0 float32", 0), ("RN", "R0 float32", 0)]
    for tag, op, launches in k3:
        S, S_host, xk, err3 = finputs[tag][f"K3 {op}"]
        off = "" if launches else " (off the path)"
        rows.append(sell_row(
            f"sell_spmv {tag} {op}{off}", "pyamg_tpu/ops/sell_kernels.py:29",
            S, to_scipy(S_host), xk, err3, f"sell_spmv {tag} {op}{off}",
            launches))
    S, xg, bg, Dinv, err5 = finputs["PW"]["K5 A1"]
    n = S.shape[0]
    tag = "sell_gs_sweep PW A1 forward"
    rows.append(row(
        tag, "pyamg_tpu/ops/sell_kernels.py:241",
        fper_op["PW"]["sell_gs_sweep"]["A1"], err5,
        lambda: sk.sell_gs_sweep(S, xg, bg, Dinv, 1.0, "forward"),
        lambda: sk.sell_gs_sweep_plain(S, xg, bg, Dinv, 1.0, "forward"),
        None, S.nnz * 8 + 4 * n * 4, 2 * S.nnz + 3 * n, source=sell_src,
        plain_reps=2, tag=tag))
    slot_model(S, 4 * n * 4, tag)
    del finputs

    # -- 10. blackbox: the one-call solve, Lloyd and Schwarz on 500^2 -------
    t0 = time.perf_counter()
    binputs, bper_op = blackbox_phase(dev, sms, rng)
    print(f"blackbox: phase before its times {time.perf_counter() - t0:.2f}"
          f" s")
    # K1 and K2 on BB A1 (27 diagonals, float64); K3 on LL P1 and R1 (t =
    # 10; R1 322 passes); K5 on LL A1 (25,000 rows, 128 passes)
    rows += dia_rows(dev, sms, row, binputs, bper_op, (("BB", "A1"),),
                     (("BB", "A1"),))
    for op in ("P1", "R1"):
        S, S_host, xk, err3 = binputs["LL"][f"K3 {op}"]
        rows.append(sell_row(
            f"sell_spmv LL {op}", "pyamg_tpu/ops/sell_kernels.py:29", S,
            to_scipy(S_host), xk, err3, f"sell_spmv LL {op}",
            bper_op["LL"]["sell_spmv"][op]))
    S, xg, bg, Dinv, err5 = binputs["LL"]["K5 A1"]
    n = S.shape[0]
    tag = "sell_gs_sweep LL A1 forward"
    rows.append(row(
        tag, "pyamg_tpu/ops/sell_kernels.py:241",
        bper_op["LL"]["sell_gs_sweep"]["A1"], err5,
        lambda: sk.sell_gs_sweep(S, xg, bg, Dinv, 1.0, "forward"),
        lambda: sk.sell_gs_sweep_plain(S, xg, bg, Dinv, 1.0, "forward"),
        None, S.nnz * 8 + 4 * n * 4, 2 * S.nnz + 3 * n, source=sell_src,
        plain_reps=2, tag=tag))
    slot_model(S, 4 * n * 4, tag)
    del binputs

    # -- 11. parallel: the row-sharded solve on a one-rank NCCL group ------
    t0 = time.perf_counter()
    parallel_phase(dev)
    print(f"parallel: phase {time.perf_counter() - t0:.2f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
