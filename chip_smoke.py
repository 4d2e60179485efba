#!/usr/bin/env python3
"""Drive pyamg_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py scale      # the device section and scale: alone

Phases, each printed on its own lines (and the second each starts at):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of the CUDA kernels from ``pyamg_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with each kernel's
   registers, shared memory, stack frame and spills from ``-Xptxas -v``;
   and the SWITCH probe of ``csrc/graph_cond.cu``;
1b. launch: before any profiler session in the process, CG and the GMRES
   family (GMRES on a V- and a W-cycle, MGS, Householder, FGMRES on a V-
   and an F-cycle, restart 100) on S1's float64 500^2 hierarchy,
   device-stopped and one graph a step in turn, bit for bit equal: the
   graphs, their nodes, the medians of both forms and of the device
   loop's launch call (``launch_phase``); then cupti: 40 profiler
   sessions one after another around device-stopped solves on that
   hierarchy, each equal to its unprofiled solve (``cupti_phase``);
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
4b. spgemm: the device form of SpGEMM (``ops/spgemm.py`` on tensors) at
   full size in float32 (``spgemm_phase``): 500^2 grid-SA A0 @ P0, the
   Galerkin product R0 @ (A0 @ P0) and ``masked_spgemm`` of A0 @ P0 on
   P0's pattern, 64^3 SA A0 @ P0 and R0 @ (A0 @ P0), and elasticity
   100^2 ``spgemm_bell`` of A0 @ P0, each against the host (scipy)
   product of the same operands (equal columns and row_nnz, each value
   within 1e-5 of its row's sum of |candidate products|), no K1-K5
   launch; ``to_scipy`` of a placed ELL, DIA and BELL equal to the host
   operator's; the device SpGEMM rate (n * WA * WB multiplies a second
   of 500^2 A0 @ P0, median of 50, CUDA events) and the host's
   (scipy's R0 @ (A0 @ P0), as ``bench.py`` counts it) with the card's
   name and power limit;
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
   package's iteration counts (``solver_paths``, ``solvers_phase``); S1,
   S2 and S6 (GMRES, FGMRES) device-stopped now, one host sync a solve
   (S6 one an inner solve);
6b. krylov: ``solve(b, tol=1e-6, accel=m)`` on S1's float64 500^2
   hierarchy (V-cycle, ``maxiter`` 100) for every Krylov method m of
   ``krylov.__all__`` but CG (BiCGStab, CGNE, CGNR, CR, minimal
   residual, steepest descent, GMRES, GMRES with modified Gram-Schmidt,
   Householder GMRES, FGMRES; ``krylov_phase``): each device-stopped,
   one host sync, bit for bit equal to its op-by-op and per-step forms
   with the same launches, iterations within 1 of the JAX package's
   (``JAX_KRYLOV``, ``tests/jax_krylov_reference.py``), CGNE's and
   CGNR's last residual and true relative residual (they run to maxiter,
   as the JAX package's do) within 1 % of the JAX package's, the warm
   medians of the three forms and one profiled per-step solve; then the
   solve's BiCGStab against the free-standing one of S5, bit for bit;
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
   (K1 and K2 on every DIA level the cycle visits; K7 alone on the
   elasticity path, whose block products and block smoothers it runs),
   warm and profiled; the elasticity fine level's ``bspmv``, block
   Gauss-Seidel color pass and sweep by their device operations; 64^2 and
   24^2 solves on the card against the CPU; and time rows for K1 and K2
   on the anisotropic A0 and A3;
8b. bell: K7 (the block product and block smoother pass) against its
   plain version, every mode, at the shapes of the benchmark's 2-D
   elasticity cell at 708^2 (levels 0-2, P0, R0, P1, float64 on level
   0, and runtime block sides on random 4 x 4 and 2 x 5 blocks), one
   solve of that cell, and K7's time rows (``bell_phase``; alone:
   ``python3 chip_smoke.py bell``);
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
   wrappers' own cost, not an exchange.  The sharded solves are
   device-stopped now (NCCL's collectives captured with the rest): at
   500^2, CG to 1e-8, 2 standalone cycles and GMRES to 1e-8 (restart 20)
   on gspmd and halo, and CG on the unsharded hierarchy, each bit for bit
   equal to its op-by-op and per-step forms with the same collectives,
   one host sync, and the warm medians of the three forms; each CG to
   1e-8 profiled once device-stopped (on gspmd and halo NCCL's
   collectives inside a WHILE body) and once one graph a step; the NCCL
   kernels are counted in a trace of the op-by-op form;
12. parallel2: the distributed setup (``parallel/dist_setup.py``) on 2-D
   Poisson, float32, the power iterations started from ``hashed_start``
   as in ``tests/jax_dist_setup_reference.py`` (JAX_DIST): the dryrun's
   SA + CG and classical + FGMRES at 32^2 on 8 ranks in this process
   (a ``StackedMesh``); SA at 1414^2 on 8 ranks, Jacobi and Chebyshev,
   CG to 1e-8; the same SA on a one-rank NCCL group (a ``RowMesh``); the
   classical setup with FGMRES at 500^2 on 8 ranks; each gated exactly
   where nothing depends on rho and within DIST_TOL elsewhere, with the
   iterations within 1 and the true relative residual within 2x of the
   JAX package's, no K1-K5 launch, and, where timed, the setup seconds by
   level, the peak memory beside the port's ``scale_model``, one profiled
   per-step solve and the collectives; every ``solve_cg`` and
   ``solve_fgmres`` device-stopped (one CUDA graph of a WHILE node, one
   host sync), and where timed bit for bit equal to its op-by-op and
   per-step forms with the warm medians of the three (``forms_gate``);
   then the one-rank hierarchy built again on a one-rank ``StackedMesh``,
   which must equal the NCCL one bit for bit.

Every solve of phases 3-12 but S5 (the free-standing
``krylov.bicgstab``, which stays op by op, as free-standing Krylov calls
do) replays CUDA graphs (``pyamg_tpu_torch/_graph.py``) as one graph
with its loops on the device and one host read a solve: standalone
cycling, CG, the double-single refined solve, every Krylov method of
``solve`` (GMRES's Arnoldi step j and its update of j steps through a
SWITCH node, one branch a j), the sharded solves and the distributed
ones.  The device section prints the SWITCH probe of
``csrc/graph_cond.cu`` (3 bodies, each run once by its index).  Each
prints ``capture:`` lines beside its phase's (``forms_gate``, which
every phase calls): the same solve device-stopped, op by op
(``_graph.eager()``) and one graph a step (``_graph.per_step()``) must
equal the phase's cold solve bit for bit (x, residual history,
iterations) with equal launches per kernel, operator and color pass and
equal collectives; a device-stopped solve must make one host sync (each
inner solve of ``solve_refined`` one), GMRES and FGMRES included,
counted by ``host_syncs`` (reads of a CUDA tensor's value and the loops'
one read of their result), as every sync count of the script is; then
the graphs captured and their capture time, the warm medians of the
three forms, one profiled op-by-op solve and ``profile_cycle`` beside
the device-stopped median per iteration.  The script sets
``TEARDOWN_CUPTI=1``, so torch.profiler detaches CUPTI after each
session and no warm median carries CUPTI's cost of about 0.4 us a graph
node a launch (``launch_ms``, printed beside each median).  The phases' own profiles of a captured solve run it one graph a step,
since the profiler may not see the kernels inside a conditional node's
body.  Phase 2 also replays a graph of 4 K2 sweeps 3
times with eager sweeps between, on the graph's exchange and on the
stream's, and a device loop of K2 sweeps (K2 inside a WHILE body)
stopped after 3, 8 and 5 sweeps, an eager sweep after each
(``k2_replay_gate``; 500^2 level 0 staged, 64^3 A0), each to 0, the
host's epoch at or above the device's; phase 5 gates ``profile_cycle``
on 500^2 (positive, below the captured solve's time an iteration) and
``trace_cycle``, whose trace (``pyamg_tpu_torch/_build/cycle_trace``)
must show K2's kernel.

Phase 10b, ``classical2:`` (``classical2_phase``), builds block AIR on
2-D linear elasticity 100^2 (BSR 2 x 2) and complex RS and AIR on
Poisson 256^2 times 1 + 0.5i (complex128), uncompressed, gates their
rows, blocksizes, layouts and operator complexity against
``JAX_CLASSICAL2`` (``tests/jax_classical2_reference.py``), and solves
each by GMRES to 1e-8 (block AIR with its default F/C Jacobi and with
block Jacobi, the JAX package's reference) and by 10 standalone cycles,
each device-stopped with one host sync: every solve the same bit for bit
in its three forms,
no K1-K6 launch (block AIR's block products and sweeps are K7's),
iterations within 1 of the JAX package's, the true
relative residual of the complex paths at most twice its.

Phase 13, ``scale:`` (``scale_phase``), runs the JAX package's two
10M-unknown single-chip configurations at full size: the main path on
2-D Poisson 3163^2 as ``benchmarks/bench_10m_solve.py`` runs it (its host
setup in a process of its own, started before phase 1b, beside the
earlier phases), its hierarchy gated against ``JAX_SCALE`` before any
solve, K1 and K2 on each of its DIA levels to 0, and the solve driven as
``drive_path`` drives a path (iterations within 1 of the JAX package's,
true relative residual below 1e-10, the three forms bit for bit); then
the SELL SpMV of ``benchmarks/bench_sell_scale.py`` on the same float32
operator's ``k_choices=(4,)`` plan, in the K4 regime: its loop of 20
products with 20 launches, against the plain version; and time rows for
K1 and K2 on levels 0 and 1 and K3 in the K4 regime on that plan.

It then prints the kernel table as one JSON line and, last, the device
line.  Any failed check exits non-zero; without a CUDA device it exits
non-zero before printing a result.
"""

import contextlib
import functools
import importlib
import json
import os
import re
import statistics
import subprocess
import time

import numpy as np

# torch.profiler detaches CUPTI after each session only when this is 1:
# left unset, CUPTI stays attached and every later launch of a device loop
# pays about 0.4 us a node of its graph (see launch_ms)
os.environ.setdefault("TEARDOWN_CUPTI", "1")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12              # H100 SXM float64 outside the tensor cores
                               # (data sheet)
SELL_SRC = "pyamg_tpu_torch/csrc/sell_kernels.cu"
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
# the JAX package's iterations and info of solve(b, tol=1e-6, accel=m) on
# S1's hierarchy (V-cycle, maxiter 100; JAX_PLATFORMS=cpu
# PYTHONPATH=.:tests python tests/jax_krylov_reference.py): the port's
# iterations must equal them within 1, and converge where they converge
JAX_KRYLOV = {"bicgstab": (4, 0), "cgne": (100, 100), "cgnr": (100, 100),
              "cr": (7, 0), "minimal_residual": (18, 0),
              "steepest_descent": (10, 0), "gmres": (6, 0),
              "gmres_mgs": (6, 0), "gmres_householder": (6, 0),
              "fgmres": (7, 0)}
# the same command's last residual and true relative residual of CGNE and
# CGNR, which run to maxiter (CG's best iterate of CGNE is its start, x = 0):
# the port's must be within 1 % of them
JAX_KRYLOV_UNCONVERGED = {"cgne": (3197.9016958258117, 1.0),
                          "cgnr": (1.8764449164185004, 0.008224960661296486)}
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
# the JAX package's 10M-unknown single-chip solve on 2-D Poisson 3163^2
# (benchmarks/bench_10m_solve.py, run on a TPU; its hardware-independent
# results as benchmarks/SOLVE_10M.json records them): levels before and
# after the coarse collapse, operator complexity to its four digits, outer
# and total inner CG iterations, true relative residual.  The port's
# iterations must equal them within 1.  The same flow on a CPU is
# tests/jax_scale_reference.py; at 10M unknowns it is a full-size run and
# is not made on the CPU of a development host (--small runs the sizes
# that tests/test_torch_scale.py holds the port to)
SCALE_N = 3163
JAX_SCALE = {"levels": 8, "active": 5, "operator_complexity": 1.2251,
             "outer": 3, "inner": 19, "true_relres": 7.793969859751499e-13}
# the JAX package's SELL plan of the same float32 operator with
# k_choices=(4,) (benchmarks/bench_sell_scale.py; benchmarks/SELL_SCALE.json)
JAX_SELL_SCALE = {"nnz": 50_010_193, "passes": 5}
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

# tests/jax_dist_setup_reference.py: the JAX package's distributed setups
# on virtual CPU devices (float32, the power iterations from hashed_start),
# with coarsen_until and the solve's arguments: levels, each level's n_loc
# and widths, margins, aggregates, dropped and stored entries, omega,
# operator complexity, iterations, relres and the true relative residual
# (float64, scipy, the unpadded operator)
JAX_DIST = {
    "sa32": {"coarsen_until": 64, "solve": {"tol": 1e-5, "maxiter": 40}, "levels":
        2, "n_loc": [128, 32], "W": [5, 24], "WP": [12], "WR": [48],
        "margins": [32, 55], "nagg": [169], "dropped": [0], "omega":
        [0.7299120792911769, 0.6851763592736448], "nnz": [4992, 1832],
        "operator_complexity": 1.3669871794871795, "coarse_n": 256,
        "iterations": 6, "relres": 3.5416353512118803e-06, "true_relres":
        3.5658504082441777e-06},
    "cl32": {"coarsen_until": 64, "solve": {"tol": 1e-5, "restart": 10,
        "max_outer": 6}, "levels": 3, "n_loc": [128, 64, 32], "W": [5, 32,
        40], "WP": [5, 32], "WR": [48, 64], "margins": [32, 60, 61], "nagg":
        [281, 96], "dropped": [0, 0], "omega": [0.43794724757470616,
        0.4312774292525311, 0.5790756501841338], "nnz": [4992, 2086, 1014],
        "operator_complexity": 1.6209935897435896, "coarse_n": 256,
        "iterations": 20, "relres": 2.5606152576074237e-07, "true_relres":
        2.121139247838761e-07},
    "sa1414": {"coarsen_until": 4096, "solve": {"tol": 1e-8, "maxiter": 40},
        "levels": 5, "n_loc": [249925, 62481, 15620, 3905, 976], "W": [5, 24,
        32, 40, 48], "WP": [12, 25, 33, 41], "WR": [48, 50, 66, 82],
        "margins": [1414, 38458, 14271, 3889, 3903], "nagg": [200493, 13741,
        690, 32], "dropped": [0, 178, 196, 4], "omega": [0.7027992661775955,
        0.9418935460097873, 0.9545414382683861, 0.9620055697209248,
        0.8053455400070659], "nnz": [9991328, 2170074, 284627, 40421, 8119],
        "operator_complexity": 1.2505413694756093, "coarse_n": 7808,
        "iterations": 27, "relres": 6.316948741869055e-09, "true_relres":
        4.59244085224111e-05},
    "cheb1414": {"coarsen_until": 4096, "solve": {"tol": 1e-8, "maxiter": 40},
        "levels": 5, "n_loc": [249925, 62481, 15620, 3905, 976], "W": [5, 24,
        32, 40, 48], "WP": [12, 25, 33, 41], "WR": [48, 50, 66, 82],
        "margins": [1414, 38458, 14271, 3889, 3903], "nagg": [200493, 13741,
        690, 32], "dropped": [0, 178, 196, 4], "omega": [0.7027992661775955,
        0.9418935460097873, 0.9545414382683861, 0.9620055697209248,
        0.8053455400070659], "nnz": [9991328, 2170074, 284627, 40421, 8119],
        "operator_complexity": 1.2505413694756093, "coarse_n": 7808,
        "iterations": 20, "relres": 5.805025349303605e-09, "true_relres":
        3.851168659333261e-05},
    "sa1414r1": {"coarsen_until": 4096, "solve": {"tol": 1e-8, "maxiter": 40},
        "levels": 6, "n_loc": [1999396, 499849, 124962, 31240, 7810, 1952],
        "W": [5, 24, 32, 40, 48, 56], "WP": [12, 25, 33, 41, 49], "WR": [48,
        50, 66, 82, 98], "margins": [1414, 1040, 366, 74, 13, 2], "nagg":
        [200493, 13769, 695, 33, 3], "dropped": [0, 138, 197, 1, 0], "omega":
        [0.7042266001351726, 0.9419561325386013, 0.9566165688167197,
        0.9609538276136209, 1.1327617946113318, 0.9999095283350937], "nnz":
        [9991324, 2170075, 284789, 40416, 8129, 1958], "operator_complexity":
        1.2507542543911097, "coarse_n": 1952, "iterations": 25, "relres":
        8.919354144154568e-09, "true_relres": 4.465114982042784e-05},
    "cl500": {"coarsen_until": 4096, "solve": {"tol": 1e-5, "restart": 10,
        "max_outer": 6}, "levels": 6, "n_loc": [31250, 15625, 7812, 3906,
        1953, 976], "W": [5, 32, 40, 48, 56, 64], "WP": [5, 32, 40, 48, 56],
        "WR": [48, 64, 80, 96, 112], "margins": [500, 2514, 4863, 3209, 1824,
        976], "nagg": [109779, 26736, 7670, 2167, 540], "dropped": [0, 0, 0,
        0, 0], "omega": [0.41828664744838334, 0.4945851115348472,
        0.4960165303207894, 0.49771783867691294, 0.5015104156157637,
        0.6471152961244322], "nnz": [1248000, 997352, 324292, 121722, 42320,
        14090], "operator_complexity": 2.2017435897435895, "coarse_n": 7808,
        "iterations": 40, "relres": 8.864345545589458e-06, "true_relres":
        8.567958577895498e-06},
}


# the parallel2: phase's tolerances on what depends on values
# (tests/jax_dist_setup_reference.py; PERF.md): the deeper levels'
# margins (the coarsest level's apart), aggregates, dropped and stored
# entries as (relative, absolute), either suffices; omega and the
# operator complexity relative.  Three times the largest deviation from
# the JAX package's float32 run that this sandbox measured: for SA over
# seeds 0, 1, 2 of the power iterations at 500^2 and 1414^2 (--spread
# 500 1414), for the classical setup, whose P reads no rho, between
# float32 and float64 at 500^2 (--float64 cl500)
DIST_TOL = {
    "sa": {"margins": (0.005, 0), "margins_coarsest": (0.75, 0),
           "nagg": (0.094, 3), "dropped": (0.18, 66), "nnz": (0.0072, 0),
           "omega": 0.078, "omega_coarsest": 0.26,
           "operator_complexity": 6.7e-5},
    "classical": {"margins": (0.012, 0), "margins_coarsest": (0.012, 0),
                  "nagg": (0.13, 72), "dropped": (0.0, 0),
                  "nnz": (0.095, 0), "omega": 0.06, "omega_coarsest": 0.045,
                  "operator_complexity": 4.7e-4}}

# the JAX package's block and complex classical paths (JAX_PLATFORMS=cpu
# PYTHONPATH=.:tests python tests/jax_classical2_reference.py): block AIR
# on 2-D linear elasticity 100^2 (BSR 2 x 2, float64, block Jacobi
# post-smoothing: the JAX package's fc_jacobi raises on a block level),
# complex RS and AIR on poisson((256, 256)) * (1 + 0.5j) in complex128;
# GMRES to 1e-8 from b = default_rng(0)
_ELL3 = ["ELL", "ELL", "ELL"]
_ELL_LAST = ["ELL", "NoneType", "NoneType"]
JAX_CLASSICAL2 = {
    "BAIR": {"rows": [20000, 5000, 3052, 1356, 622, 327, 164, 77, 37, 18],
             "blocksizes": [[2, 2]] + [[1, 1]] * 9,
             "operator_complexity": 3.3205120264852934,
             "layouts": [["BELL", "BELL", "BELL"]] + [_ELL3] * 8 +
             [_ELL_LAST],
             "iterations": 99, "true_relres": 1.0163236464198251e-07},
    "CRS": {"rows": [65536, 32768, 8252, 2080, 527, 135, 27, 6],
            "blocksizes": [[1, 1]] * 8,
            "operator_complexity": 2.196931940634796,
            "layouts": [_ELL3] * 7 + [_ELL_LAST],
            "iterations": 6, "true_relres": 1.6633950397547912e-08},
    "CAIR": {"rows": [65536, 32768, 8258, 2081, 548, 217, 99, 47, 23, 8],
             "blocksizes": [[1, 1]] * 10,
             "operator_complexity": 2.5652919278996866,
             "layouts": [_ELL3] * 9 + [_ELL_LAST],
             "iterations": 37, "true_relres": 1.4164101800200272e-08}}

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
    """Build every CUDA source of the port at once (one nvcc each): the
    kernels and the conditional graph nodes of the device loops."""
    from concurrent.futures import ThreadPoolExecutor
    from pyamg_tpu_torch.ops import launch
    names = ("dia_kernels", "sell_kernels", "dist_kernels", "bell_kernels",
             "graph_cond")
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(launch.build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


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
    device ops [(name, start, end)], host syncs, as ``host_syncs`` counts
    them).  The profiler may not see the kernels that run inside a
    conditional node's body (a device-stopped loop): busy time is then
    that of the rest alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for k in range(TRACE_TRIES):    # as device_events: a trace with no
        if k:                       # device operation is taken again
            time.sleep(TRACE_PAUSE_S)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            syncs = host_syncs(fn)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ops = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
    scipy A, b, tol, kernels it must launch, M, (hierarchy, cycle) of a
    captured solve or None)], ``run(residuals)`` returning (x, info).  The true relative residual is checked below tol,
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
         S2, b, 1e-6, dia, s1_precond, (s1, "W")),
        ("S2", "FGMRES around an F-cycle, SOR omega 1.2, LU coarse solve",
         lambda res: s2.solve(b, tol=1e-6, accel="fgmres", cycle="F",
                              residuals=res, return_info=True),
         S2, b, 1e-6, dia, None, (s2, "F")),
        ("S3", "CG around a V-cycle, Chebyshev degree 3, Cholesky coarse "
         "solve", lambda res: s3.solve(b, tol=1e-6, accel="cg",
                                       residuals=res, return_info=True),
         S2, b, 1e-6, ("dia_spmv",), None, (s3, "V")),
        ("S4", "standalone AMLI cycling, Jacobi omega 4/3 twice",
         lambda res: s4.solve(b, tol=1e-6, cycle="AMLI", maxiter=60,
                              residuals=res, return_info=True),
         S2, b, 1e-6, ("dia_spmv",), None, (s4, "AMLI")),
        # BiCGStab is one of the Krylov methods that stay op by op
        ("S5", "krylov.bicgstab preconditioned by S1's V-cycle",
         lambda res: krylov.bicgstab(s1.levels[0].A, b, tol=1e-6,
                                     M=s1.aspreconditioner("V"),
                                     residuals=res),
         S2, b, 1e-6, dia, None, None),
        ("S6", "solve_refined GMRES around a W-cycle, SOR omega 1.2 forward "
         "and backward", s6_run, S3, b3, 1e-10,
         dia + ("sell_spmv", "sell_gs_sweep"), None, (s6, "W")),
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
    for name, what, run, S, b, tol, must, M, captured in paths:
        reset_kernel_launches()
        res = []
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            x, info = run(res)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
        counts = counters()
        x_cold = x
        launches = {k.__name__: k.launches for k in kernels}
        per_op = {k.__name__: dict(k.by_op) for k in kernels if k.launches}
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
        print_profile(f"{name} captured per step",
                      *profiled(per_step(lambda: run([]))), phase="solvers")
        if captured is not None:
            def replayed(run=run):
                r = []
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    xr, i = run(r)
                return xr, r, i if name == "S6" else (i, len(r) - 1)

            forms_gate("solvers", name, replayed,
                       # one host sync a solve; S6 one an inner solve
                       (lambda it: len(it[1])) if name == "S6" else 1,
                       captured[0], reps,
                       ((x_cold, res, info if name == "S6" else
                         (info, len(res) - 1)), counts), captured[1],
                       op_profile=True)
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


def krylov_phase(dev, ml, S, b, want=None, reps=3):
    """The ``krylov:`` phase: ``ml.solve(b, tol=1e-6, accel=m)`` for every
    Krylov method m of ``krylov.__all__`` but CG on S1's hierarchy (a
    V-cycle, ``maxiter`` 100; ``S`` its operator in scipy), each cold
    device-stopped with the launch counts set to 0 just before and read
    just after, then against its op-by-op and per-step forms
    (``forms_gate``: bit for bit, one host sync device-stopped, the warm
    medians of the three forms) and one profiled per-step solve; the
    iterations within 1 of the JAX package's (``want``, JAX_KRYLOV),
    ``info`` 0 where the JAX package's is 0, K1 and K2 (the hierarchy's
    DIA levels) launched and no other kernel.  CGNE and CGNR converge
    neither here nor in the JAX package: their last residual and true
    relative residual must be within 1 % of the JAX package's
    (JAX_KRYLOV_UNCONVERGED).  Then ``solve(accel="bicgstab")`` against
    the free-standing ``krylov.bicgstab`` of S5 on the same V-cycle, bit
    for bit."""
    import warnings
    import torch
    from pyamg_tpu_torch import krylov
    want = JAX_KRYLOV if want is None else want
    bn = b.cpu().numpy()
    kept = {}
    for m in krylov.__all__:
        if m == "cg":
            continue

        def run(m=m):
            res = []
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                x, info = ml.solve(b, tol=1e-6, accel=m, residuals=res,
                                   return_info=True)
            return x, res, (info, len(res) - 1)

        reset_kernel_launches()
        t0 = time.perf_counter()
        x, res, it = run()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        counts = counters()
        launches = kernel_launches()
        kept[m] = (x.clone(), res)
        its, info = it[1], it[0]
        ref_its, ref_info = want[m]
        xn = x.cpu().numpy()
        true = float(np.linalg.norm(bn - S @ xn) / np.linalg.norm(bn))
        print(f"krylov: {m}: iterations {its} (JAX package {ref_its}), info "
              f"{info} (JAX package {ref_info}), last residual {res[-1]!r}, "
              f"true relative residual {true!r}, cold {cold:.3f} s (the "
              f"capture of every step included), launches per solve "
              f"{launches}")
        print_profile(f"{m} captured per step", *profiled(per_step(run)),
                      phase="krylov")
        forms_gate("krylov", m, run, 1, ml, reps, ((x, res, it), counts),
                   "V")
        check(abs(its - ref_its) <= 1 and (info == 0) == (ref_info == 0),
              f"krylov {m}: {its} iterations and info {info}, the JAX "
              f"package's {ref_its} and {ref_info}")
        if m in JAX_KRYLOV_UNCONVERGED:
            ref_last, ref_true = JAX_KRYLOV_UNCONVERGED[m]
            check(abs(res[-1] - ref_last) <= 0.01 * ref_last and
                  abs(true - ref_true) <= 0.01 * ref_true,
                  f"krylov {m}: last residual {res[-1]!r} and true relative "
                  f"residual {true!r}, not within 1 % of the JAX package's "
                  f"{ref_last!r} and {ref_true!r}")
        check(bool(torch.isfinite(x).all()) and x.shape == b.shape,
              f"krylov {m}: x is not a finite vector of the fine size")
        check(launches["dia_spmv"] > 0 and launches["dia_gs_sweep"] > 0 and
              all(v == 0 for k, v in launches.items()
                  if k not in ("dia_spmv", "dia_gs_sweep")),
              f"krylov {m}: launches {launches}, expected K1 and K2 only")
    res = []
    x, info = krylov.bicgstab(ml.levels[0].A, b, tol=1e-6,
                              M=ml.aspreconditioner("V"), residuals=res)
    same = torch.equal(x, kept["bicgstab"][0]) and res == kept["bicgstab"][1]
    print(f"krylov: solve(accel='bicgstab') against the free-standing "
          f"krylov.bicgstab (S5, op by op): bit for bit equal {same}, "
          f"{len(res) - 1} iterations")
    check(same, "krylov: solve's BiCGStab differs from the free-standing "
                "one")


def counters():
    """Every kernel wrapper's counters: {kernel: (launches, per operator,
    color passes)}."""
    from pyamg_tpu_torch.ops import bell_kernels as bk
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import dist_kernels as tk
    from pyamg_tpu_torch.ops import sell_kernels as sk
    return {k.__name__: (k.launches, dict(k.by_op),
                         dict(getattr(k, "passes", {})))
            for k in dk.KERNELS + sk.KERNELS + tk.KERNELS + bk.KERNELS}


def total_iterations(it):
    """The Krylov iterations or cycles of one solve, from what its path
    reports: ``{'inner': [...]}`` or ``{'inner': n}``, ``{'cg': n}``, an
    (outer, inner counts) pair or an (info, iterations) pair."""
    if isinstance(it, dict):
        inner = it.get("inner", it.get("cg"))
        return sum(inner) if isinstance(inner, (list, tuple)) else inner
    if isinstance(it, tuple):
        return sum(it[1]) if isinstance(it[1], (list, tuple)) else it[1]
    return it


def per_step(fn):
    """``fn`` run with a captured solve's loops on the host, one graph a
    step (``_graph.per_step()``), as the solves ran before their stop
    moved onto the device."""
    from pyamg_tpu_torch import _graph

    def run(*args, **kwargs):
        with _graph.per_step():
            return fn(*args, **kwargs)
    return run


def forms_gate(phase, tag, run, reads=1, ml=None, reps=3, cold=None,
               cycle=None, op_profile=False):
    """One solve in its three forms, held bit for bit.  ``run()`` solves
    once and returns (x, more...), x a tensor or an array and the rest
    compared by ``==``.  It runs device-stopped (the default form), op by
    op (``_graph.eager()``) and one graph a step (``per_step``), with the
    kernels' counters and the collectives (``partition.COUNTS``) set to 0
    just before each and read just after; ``cold``, the caller's own first
    solve in the default form and its ``counters()``, is held to the same.
    Each must give the same x and rest bit for bit, the same launches per
    kernel, operator and color pass, and the same collectives.  A
    device-stopped solve must make ``reads`` host syncs (``host_syncs``;
    an int, or a function of the result's third element, its
    iterations); the per-step form's are printed beside.  With ``reps``:
    the warm medians of the three forms (the device-stopped and per-step
    solves taken in turn, ``reps`` each, 3 where one solve takes over 0.3
    s; op by op min(``reps``, 3), 1 where one takes over a second), one
    profiled op-by-op solve where ``op_profile`` (not over a second) and
    the device loops' launch calls (``launch_ms``).  With ``ml`` (a
    ``MultilevelSolver``) the graphs it captured and their capture
    seconds; with ``cycle`` ``profile_cycle(cycle)`` beside the
    device-stopped median an iteration.  Returns {"medians": {form:
    seconds}, "result": the first solve's result, "collectives": its
    collectives, "launches": {kernel: launches}, "cycle_s": the
    profile_cycle seconds or None}."""
    import torch
    from pyamg_tpu_torch import _graph
    from pyamg_tpu_torch.parallel import partition
    forms = (("device-stopped", contextlib.nullcontext),
             ("op by op", _graph.eager), ("per step", _graph.per_step))
    out = {} if cold is None else {"cold": (cold[0], cold[1], None)}
    slowest = 0.0
    for form, ctx in forms:
        partition.reset_counts()
        reset_kernel_launches()
        with ctx():
            t0 = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            if form != "device-stopped":    # its first solve records
                slowest = max(slowest, time.perf_counter() - t0)
        out[form] = (got, counters(), dict(partition.COUNTS))

    def host(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)

    first, counts, colls = next(iter(out.values()))
    colls = colls if colls is not None else out["device-stopped"][2]
    x0 = host(first[0])
    same = {}
    for form, (got, c, k) in out.items():
        x = host(got[0])
        same[form] = bool(x.shape == x0.shape and np.array_equal(x, x0) and
                          got[1:] == first[1:] and c == counts and
                          (k is None or k == colls))
    syncs = host_syncs(run)
    step_syncs = host_syncs(per_step(run))
    want = reads(first[2]) if callable(reads) else reads
    print(f"capture: {phase} {tag}: {', '.join(out)} bit for bit equal "
          f"{same} (x, the rest {str(first[1:])[:160]}, launches, "
          f"collectives {colls}); host syncs device-stopped {syncs} (want "
          f"{want}), per step {step_syncs}")
    check(all(same.values()), f"{tag}: the solve's forms differ: {same}")
    check(syncs == want, f"{tag}: the device-stopped solve made {syncs} "
                         f"host syncs, not {want}")
    med = {}
    if reps:
        walls = {"device-stopped": [], "per step": [], "op by op": []}
        for _ in range(3 if slowest > 0.3 else reps):
            for form, fn in (("device-stopped", run),
                             ("per step", per_step(run))):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[form].append(time.perf_counter() - t0)
        with _graph.eager():
            for _ in range(1 if slowest > 1.0 else min(reps, 3)):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls["op by op"].append(time.perf_counter() - t0)
            if op_profile and slowest <= 1.0:
                print_profile(f"{tag} op by op", *profiled(run),
                              phase=phase)
        med = {k: statistics.median(v) for k, v in walls.items()}
        print(f"capture: {phase} {tag}: warm medians device-stopped "
              f"{med['device-stopped'] * 1e3:.3f} ms, per step "
              f"{med['per step'] * 1e3:.3f} ms, op by op "
              f"{med['op by op'] * 1e3:.3f} ms (all "
              f"{[[round(w * 1e3, 3) for w in v] for v in walls.values()]});"
              f" per step / device-stopped "
              f"{med['per step'] / med['device-stopped']:.3f}x, op by op / "
              f"device-stopped {med['op by op'] / med['device-stopped']:.2f}"
              f"x; the device loops' launch calls {launch_ms(run):.3f} ms "
              f"of host time a solve (see launch_ms)")
    if ml is not None:
        graphs, capture_s = ml._graphs().captured()
        print(f"capture: {phase} {tag}: graphs {graphs} captured in "
              f"{capture_s:.3f} s (paid once)")
    t_cycle = None
    if cycle is not None:
        key = (id(ml), cycle)
        if key not in _CYCLE_S:
            _CYCLE_S[key] = ml.profile_cycle(cycle)
        t_cycle = _CYCLE_S[key]
        iters = total_iterations(first[2])
        line = f"capture: {phase} {tag}: profile_cycle({cycle}) " \
            f"{t_cycle * 1e3:.4f} ms"
        if med:
            line += f", device-stopped median / {iters} iterations " \
                f"{med['device-stopped'] / max(iters, 1) * 1e3:.4f} ms"
        print(line)
    return {"medians": med, "result": first, "collectives": colls,
            "launches": {k: v[0] for k, v in counts.items()},
            "cycle_s": t_cycle}


_CYCLE_S = {}       # profile_cycle of (hierarchy, cycle), taken once


def launch_ms(run):
    """Host milliseconds of the device loops' launch calls in one call of
    ``run``: while CUPTI is attached (inside a torch.profiler session, or
    after one unless ``TEARDOWN_CUPTI=1``) each launch of a device loop
    costs about 0.4 us for every node of its graph, the branches not
    taken included; outside a session it costs about 0.1 ms
    (``launch_phase``)."""
    from pyamg_tpu_torch import _graph
    real, spent = _graph._DeviceLoop.launch, []

    def timed(self):
        t0 = time.perf_counter()
        real(self)
        spent.append(time.perf_counter() - t0)

    _graph._DeviceLoop.launch = timed
    try:
        run()
    finally:
        _graph._DeviceLoop.launch = real
    return sum(spent) * 1e3


def launch_phase(dev, reps=5):
    """The ``launch:`` phase, run before any profiler session in the
    process: on S1's hierarchy (``build_hierarchy``: float64 grid SA of
    2-D Poisson 500^2, its coarse tail collapsed to 4096 rows; b from
    SEED), ``solve(b, tol=1e-6, accel=m, cycle=c, maxiter=100)`` for CG
    and the GMRES family (100 the restart), device-stopped and one graph
    a step in turn, ``reps`` warm solves each, both bit for bit equal to
    the first solve (x and history).  Prints the graphs, their nodes, the
    first solve's seconds (every step recorded), the medians of the two
    forms and of the device loop's launch call (host time,
    ``launch_ms``).  While CUPTI is attached each launch of a device loop
    costs about 0.4 us a node of its graph: these are the medians of a
    process that has never attached it."""
    import torch
    from pyamg_tpu_torch import _graph
    A, ml, _ = build_hierarchy(500, 4096, dev, ds=False, dtype=np.float64)
    ml.to_device(dev)
    b = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
        A.shape[0]), device=dev)
    for m, cycle in (("cg", "V"), ("gmres", "V"), ("gmres", "W"),
                     ("gmres_mgs", "V"), ("gmres_householder", "V"),
                     ("fgmres", "V"), ("fgmres", "F")):
        def run(m=m, cycle=cycle):
            res = []
            x = ml.solve(b, tol=1e-6, accel=m, cycle=cycle, maxiter=100,
                         residuals=res)
            return x, res

        t0 = time.perf_counter()
        x, res = run()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        prog = ml._graphs().programs[(m, cycle, 1e-6, 100)]
        nodes = sum(sum(_graph.node_types(g.raw()).values())
                    for g, _ in prog.graphs.values())
        walls = {"device-stopped": [], "per step": []}
        launch = []
        for _ in range(reps):
            for form, fn in (("device-stopped", run),
                             ("per step", per_step(run))):
                t0 = time.perf_counter()
                got = fn()
                torch.cuda.synchronize()
                walls[form].append(time.perf_counter() - t0)
                check(torch.equal(got[0], x) and got[1] == res,
                      f"launch: {m} {cycle}-cycle {form} differs from the "
                      f"first solve")
            launch.append(launch_ms(run))
        med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
        print(f"launch: {m} {cycle}-cycle, {len(res) - 1} iterations: "
              f"{len(prog.graphs)} graphs, {nodes} nodes, first solve "
              f"{cold:.3f} s (every step recorded); medians of {reps}: "
              f"device-stopped {med['device-stopped']:.3f} ms, per step "
              f"{med['per step']:.3f} ms (per step / device-stopped "
              f"{med['per step'] / med['device-stopped']:.3f}x), the device "
              f"loop's launch call {statistics.median(launch):.3f} ms (all "
              f"{[[round(w * 1e3, 3) for w in v] for v in walls.values()]})")
    return ml, b


def cupti_phase(ml, b, rounds=40):
    """The ``cupti:`` phase, right after ``launch_phase`` on its hierarchy:
    ``rounds`` torch.profiler sessions one after another, each around a
    device-stopped solve, CG recorded afresh (a new tol each round) and
    GMRES of restart 100 replayed in turn, each bit for bit equal to the
    same solve made just before without the profiler.  With
    ``TEARDOWN_CUPTI=1`` (the script's setting) torch.profiler tears CUPTI
    down after each session and attaches it again in the next; the phase
    holds that this runs beside the device loops as often as the later
    phases make it."""
    import torch
    t0 = time.perf_counter()
    for k in range(rounds):
        m = ("cg", "gmres")[k % 2]
        tol = 1e-6 * (1 + k) if m == "cg" else 1e-6

        def run(m=m, tol=tol):
            res = []
            return ml.solve(b, tol=tol, accel=m, maxiter=100,
                            residuals=res), res

        x, res = run()              # CG's first solve records its program
        got = []
        profiled(lambda: got.extend(run()))
        check(torch.equal(got[0], x) and got[1] == res,
              f"cupti: round {k} ({m}) differs under the profiler")
    print(f"cupti: {rounds} profiler sessions around device-stopped solves "
          f"({(rounds + 1) // 2} CGs recorded afresh, {rounds // 2} GMRES "
          f"replays), TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}, "
          f"each equal to its solve without the profiler; "
          f"{time.perf_counter() - t0:.2f} s")


def host_syncs(run):
    """The host syncs of one call of ``run``, counted without the
    profiler: reads of a CUDA tensor's value (``item``, ``bool``,
    ``int``, ``float``, ``index``) and the solve loops' one read of their
    result (``_graph.read``)."""
    import torch
    from pyamg_tpu_torch import _graph
    count = [0]
    real = {name: getattr(torch.Tensor, name) for name in
            ("item", "__bool__", "__int__", "__float__", "__index__")}

    def counted(name):
        def fn(self, *args, **kwargs):
            if self.is_cuda:
                count[0] += 1
            return real[name](self, *args, **kwargs)
        return fn

    real_read = _graph.read

    def read(tensors):
        count[0] += 1
        return real_read(tensors)

    try:
        for name in real:
            setattr(torch.Tensor, name, counted(name))
        _graph.read = read
        run()
    finally:
        for name, fn in real.items():
            setattr(torch.Tensor, name, fn)
        _graph.read = real_read
    return count[0]


def k2_replay_gate(dev, name, D, colors, nc, Dinv):
    """K2 in a CUDA graph: one graph of 4 symmetric sweeps (omega 1) on
    ``D``, replayed 3 times on new x.  After each replay two eager K2
    sweeps run on the same stream: one in the warm-up of a new step of the
    same program (so on the exchange the graph recorded, as when GMRES
    records its next Arnoldi step between replays), one outside any
    program (the stream's exchange).  Every replay and every eager sweep
    must equal the plain version bit for bit."""
    import torch
    from pyamg_tpu_torch import _graph
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.relaxation.relaxation import gs_order
    n = D.shape[0]
    data = torch.as_tensor(D.data, device=dev).float()
    col = torch.as_tensor(colors, device=dev)
    Di = torch.as_tensor(Dinv, device=dev).float()
    order = gs_order(nc, "symmetric", 1, 1.0)
    rng = np.random.default_rng(SEED)
    b = torch.as_tensor(rng.standard_normal(n), device=dev).float()

    def plain(x, sweeps):
        for _ in range(sweeps):
            x = dk.dia_gs_sweep_plain(data, D.offsets, n, x, b, Di, col,
                                      order, 1.0)
        return x

    def step(s):
        x = s["x"]
        for _ in range(4):
            x = dk.dia_gs_sweep(data, D.offsets, n, x, b, Di, col, order)
        return {"y": x}

    def one(s):
        return {"e": dk.dia_gs_sweep(data, D.offsets, n, s["x"], b, Di, col,
                                     order)}

    prog = _graph.Cache().transient(dev)
    errs = []
    with torch.cuda.stream(prog.stream):
        prog.put("x", torch.as_tensor(rng.standard_normal(n),
                                      device=dev).float())
        prog.run("sweeps", step)
        for k in range(3):
            x = torch.as_tensor(rng.standard_normal(n), device=dev).float()
            prog.put("x", x)
            prog.run("sweeps", step)
            errs.append(float((prog.state["y"] - plain(x, 4)).abs().max()))
            prog.run(("one", k), one)      # its warm-up: an eager sweep
            errs.append(float((prog.state["e"] - plain(x, 1)).abs().max()))
            e = dk.dia_gs_sweep(data, D.offsets, n, x, b, Di, col, order)
            errs.append(float((e - plain(x, 1)).abs().max()))
        torch.cuda.synchronize()
    g = dk.gs_geometry(n, len(D.offsets), max(abs(o) for o in D.offsets), 4)
    print(f"capture: K2 replay {name} ({len(order)} passes, {g}): graph of 4 "
          f"sweeps replayed 3 times, each followed by an eager sweep on the "
          f"graph's exchange and one on the stream's, max_abs_err {errs}")
    check(all(e == 0 for e in errs), f"K2 {name}: a replayed or eager sweep "
                                     f"disagrees with its plain version")

    # K2 inside a WHILE body (a cooperative launch in a conditional node):
    # a device loop of sweeps that stops after `want` of them, replayed
    # with different counts, an eager sweep after each replay
    def start(s):
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return {"y": s["x0"] + 0, "it": zero, "stop": zero > 0}

    def sweep(s):
        it = s["it"] + 1
        return {"y": dk.dia_gs_sweep(data, D.offsets, n, s["y"], b, Di, col,
                                     order), "it": it,
                "stop": it >= s["want"]}

    loop = _graph.Cache().transient(dev)
    tree = [_graph.Step(loop, "start", start),
            _graph.While(loop, [_graph.Step(loop, "sweep", sweep)], 8)]
    errs, epochs = [], []
    for want in (3, 8, 5):
        x = torch.as_tensor(rng.standard_normal(n), device=dev).float()
        loop.put("x0", x)
        loop.put("want", torch.tensor(want, dtype=torch.int32, device=dev))
        before = dk.dia_gs_sweep.launches
        (trips,) = loop.loop("k2", tree, ("it",))
        launched = dk.dia_gs_sweep.launches - before
        errs.append(float((loop.state["y"] - plain(x, want)).abs().max()))
        e = dk.dia_gs_sweep(data, D.offsets, n, x, b, Di, col, order)
        errs.append(float((e - plain(x, 1)).abs().max()))
        ex = loop.owned[("dia_gs_exchange", data.device)]
        epochs.append((ex.epoch, int(ex.ctl[0])))
        check(trips == want and launched == want,
              f"K2 {name}: the device loop ran {trips} trips and counted "
              f"{launched} launches, not {want}")
    print(f"capture: K2 device loop {name}: WHILE of sweeps stopped on the "
          f"device after 3, 8 and 5 sweeps, an eager sweep after each, "
          f"max_abs_err {errs}; (host, device) epochs after each replay "
          f"{epochs}")
    check(all(e == 0 for e in errs), f"K2 {name}: a sweep in the device loop "
                                     f"or after it disagrees with its plain "
                                     f"version")
    check(all(h >= d for h, d in epochs),
          f"K2 {name}: the host's epoch fell below the device's")


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


def slot_model(S, vectors_bytes, tag):
    """Print the bytes of a SELL plan's padded slots beside the bound."""
    from pyamg_tpu_torch.sparse.sell import LANE
    T, Sy, _ = S.vals.shape
    nbytes = T * Sy * LANE * 8 + vectors_bytes
    print(f"times: {tag} plan-slot byte model ({T * Sy * LANE} slots for "
          f"{S.nnz} stored entries): {nbytes / HBM_BYTES_PER_S * 1e6:.2f} "
          f"us ({nbytes / 1e6:.2f} MB)")


def sell_spmv_row(row, dev, name, replaces, S, S_scipy, x, err, tag,
                  launches):
    """K3/K4 at one operator (``row``: ``kernel_row`` with its flush):
    bound from its stored entries (value and column each), x read and y
    written; 2 flops per stored entry; the library call is torch.sparse's
    CSR product of ``S_scipy``."""
    from pyamg_tpu_torch.ops import sell_kernels as sk
    lib = csr_on(S_scipy, dev)
    e_lib, scale = rel_err(lib @ x, sk.sell_spmv_plain(S, x))
    check(e_lib <= 1e-5 * scale, f"library CSR product disagrees ({tag})")
    vectors = (S.shape[0] + S.shape[1]) * 4
    r = row(name, replaces, launches, err, lambda: sk.sell_spmv(S, x),
            lambda: sk.sell_spmv_plain(S, x), lambda: lib @ x,
            S.nnz * 8 + vectors, 2 * S.nnz, source=SELL_SRC, plain_reps=5,
            tag=tag)
    slot_model(S, vectors, tag)
    return r


def spgemm_products(n2=500, n3=64, n_el=100):
    """The ``spgemm:`` phase's operands, built on the host in float32 as
    ``bench.py`` and ``bench_suite.py`` build them, uncompressed: ``{tag:
    (A, B)}`` for ``A @ B``, where ``B`` None stands for the product before
    (the Galerkin product ``R @ (A @ P)``), and the level 0 of the 500^2
    and the elasticity hierarchies."""
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import linear_elasticity, poisson
    t0 = time.perf_counter()
    sa2 = smoothed_aggregation_solver(poisson((n2, n2)).astype(np.float32),
                                      aggregate=("grid", {}),
                                      max_coarse=10).levels[0]
    sa3 = smoothed_aggregation_solver(
        poisson((n3, n3, n3)).astype(np.float32), max_coarse=50).levels[0]
    A_el, B_el = linear_elasticity((n_el, n_el))
    el = smoothed_aggregation_solver(A_el.astype(np.float32), B=B_el,
                                     max_coarse=50).levels[0]
    print(f"spgemm: setup of {n2}^2 grid SA, {n3}^3 SA and elasticity "
          f"{n_el}^2 (float32, uncompressed) {time.perf_counter() - t0:.2f} "
          f"s")
    return {f"{n2}^2 A@P": (sa2.A, sa2.P), f"{n2}^2 R@(A@P)": (sa2.R, None),
            f"{n3}^3 A@P": (sa3.A, sa3.P), f"{n3}^3 R@(A@P)": (sa3.R, None),
            f"elasticity {n_el}^2 A@P": (el.A, el.P)}, (sa2, el)


def on_host(M):
    """A placed ELL or BELL with its tensors copied to the host."""
    import dataclasses
    return dataclasses.replace(M, **{f: getattr(M, f).cpu().numpy()
                                     for f in ("cols", "vals", "row_nnz")})


def spgemm_bound(A, B):
    """Each row's sum of |candidate products| of ``A @ B`` (host or placed
    operands), the scale of the product's rounding: the row sums of |A| @
    |B| in float64, ``(n, 1)``, or by block entry for blocks, ``(nb, 1,
    br, bc)``."""
    import scipy.sparse as sp
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    br, bc = A.blocksize[0], B.blocksize[1]
    C = abs(to_scipy(A).astype(np.float64)) @ \
        abs(to_scipy(B).astype(np.float64))
    m = C.shape[1]
    phase = sp.csr_matrix((np.ones(m), (np.arange(m), np.arange(m) % bc)),
                          shape=(m, bc))
    sums = (C @ phase).toarray()
    return sums if (br, bc) == (1, 1) else sums.reshape(-1, br, bc)[:, None]


def spgemm_ratio(got, want, bound):
    """max |got - want| / bound of host arrays (0 where they are equal)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(np.divide(diff, bound, out=np.zeros_like(diff),
                           where=diff > 0).max())


def spgemm_gate(tag, got, want, bound, tol=1e-5):
    """A device product against the host product of the same operands:
    equal columns and row_nnz, every value within ``tol`` times its row's
    sum of |candidate products|.  Returns the largest ratio."""
    got = on_host(got)
    same = got.shape == want.shape and got.width == want.width and all(
        np.array_equal(getattr(got, f), getattr(want, f))
        for f in ("cols", "row_nnz"))
    ratio = spgemm_ratio(got.vals, want.vals, bound)
    print(f"spgemm: {tag} {want.shape} width {want.width}, columns and "
          f"row_nnz equal {same}, largest |device - host| / row sum of "
          f"|candidates| {ratio:.3e} (tol {tol:g})")
    check(same and ratio <= tol, f"spgemm: the device {tag} differs from "
                                 f"the host product")
    return ratio


def spgemm_phase(dev, card, reps=50, n2=500, n3=64, n_el=100):
    """The ``spgemm:`` phase: the device form of SpGEMM (``ops/spgemm.py``
    on tensors: ``_expand``, ``rowops.dedup_rows``) at full size in
    float32, each product against the host (scipy) product of the same
    operands (``spgemm_gate``): on the 500^2 grid-SA main path (the
    hierarchy before ``compress_stencils``) A0 @ P0, the Galerkin product
    R0 @ (A0 @ P0) and ``masked_spgemm`` of A0 @ P0 on P0's pattern; on
    the 64^3 standard-SA path A0 @ P0 and R0 @ (A0 @ P0); on elasticity
    100^2 ``spgemm_bell`` of A0 @ P0 (BELL).  No K1-K5 launch.  Then
    ``to_scipy`` of a placed 500^2 level-0 ELL, DIA and elasticity BELL
    against that of the host operator, exactly; and the rates as
    ``bench.py`` computes them: the device's n * WA * WB multiplies a
    second of ``_expand`` + ``dedup_rows`` of the 500^2 A0 @ P0 (median of
    ``reps`` warm calls, CUDA events) and the host's (nnz(A) * width(P) +
    nnz(Ac) * width(R)) / t of scipy's R0 @ (A0 @ P0) (median of 3),
    printed with ``card`` (the card's name and power limit)."""
    import torch
    sg = importlib.import_module("pyamg_tpu_torch.ops.spgemm")
    from pyamg_tpu_torch.ops.rowops import dedup_rows
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell, to_scipy
    products, (sa2, el) = spgemm_products(n2, n3, n_el)
    reset_kernel_launches()
    t0 = time.perf_counter()
    worst, last = 0.0, None
    for tag, (A, B) in products.items():
        if B is None:       # R @ (the device's product before, and its copy)
            B, Bd = on_host(last), last
        else:
            Bd = B.to(dev)
        Ad = A.to(dev)
        prod = sg.spgemm_bell if A.blocksize != (1, 1) else sg.spgemm
        got, want = prod(Ad, Bd), prod(A, B)
        torch.cuda.synchronize()
        check(isinstance(got.vals, torch.Tensor) and got.vals.device.type
              == torch.device(dev).type and isinstance(want.vals,
                                                        np.ndarray),
              f"spgemm: {tag} did not run on the card and the host")
        worst = max(worst, spgemm_gate(tag, got, want, spgemm_bound(A, B)))
        last = got
    A, P = sa2.A, sa2.P
    Ad, Pd = A.to(dev), P.to(dev)
    pc, pv = torch.as_tensor(P.cols, device=dev), \
        torch.as_tensor(P.valid_mask(), device=dev)
    got = sg.masked_spgemm(Ad, Pd, pc, pv)
    want = sg.masked_spgemm(A, P, P.cols, P.valid_mask())
    ratio = spgemm_ratio(got.cpu().numpy(), want, spgemm_bound(A, P))
    print(f"spgemm: masked {n2}^2 A@P on P's pattern {tuple(want.shape)}, "
          f"largest |device - host| / row sum of |candidates| {ratio:.3e} "
          f"(tol 1e-05)")
    check(got.shape == want.shape and ratio <= 1e-5,
          "spgemm: the device masked A@P differs from the host's")
    worst = max(worst, ratio)
    launched = kernel_launches()
    print(f"spgemm: products {time.perf_counter() - t0:.2f} s, largest "
          f"ratio {worst:.3e}, kernel launches {launched}")
    check(all(v == 0 for v in launched.values()),
          f"spgemm: a K1-K5 kernel launched: {launched}")

    # to_scipy of placed operators
    for tag, M in ((f"{n2}^2 level-0 ELL", A),
                   (f"{n2}^2 level-0 DIA", dia_from_ell(A)),
                   (f"elasticity {n_el}^2 level-0 BELL", el.A)):
        want, got = to_scipy(M), to_scipy(M.to(dev))
        same = got.format == want.format and got.shape == want.shape and \
            all(np.array_equal(getattr(got, f), getattr(want, f))
                for f in ("indptr", "indices", "data"))
        print(f"spgemm: to_scipy of a placed {tag} equals the host's {same}")
        check(same, f"to_scipy of a placed {tag} differs from the host's")

    # the rates
    n_cols = P.shape[1]
    torch.cuda.synchronize()
    ms = []
    for k in range(reps + 3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        dedup_rows(*sg._expand(Ad, Pd), n_cols)
        stop.record()
        stop.synchronize()
        if k >= 3:
            ms.append(start.elapsed_time(stop))
    t_dev = statistics.median(ms) / 1e3
    mults = A.shape[0] * A.width * P.width
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        Ac = sg.spgemm(sa2.R, sg.spgemm(A, P))
        walls.append(time.perf_counter() - t0)
    t_host = statistics.median(walls)
    host_rate = (A.nnz * P.width + Ac.nnz * sa2.R.width) / t_host
    print(f"spgemm: device rate {mults / t_dev / 1e9:.4f} G multiplies/s "
          f"(_expand + dedup_rows of {n2}^2 A@P: n * WA * WB = {A.shape[0]} "
          f"* {A.width} * {P.width}, median {t_dev * 1e3:.4f} ms of {reps} "
          f"warm calls, CUDA events, all {[round(m, 4) for m in ms]}); host "
          f"rate {host_rate / 1e9:.4f} Gnnz/s (scipy R@(A@P), median "
          f"{t_host:.4f} s of 3); on {card}")


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
                out["sell_spmv"][name] = sk.sell_spmv.by_op[key]
                if attr == "A" and lvl.pre[0] == "gauss_seidel":
                    out["sell_gs_sweep"][name] = sk.sell_gs_sweep.by_op[key]
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
    counts = counters()
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
    print_profile(f"{tag} captured per step", *profiled(per_step(solve)),
                  phase=phase)

    def run():
        r, i = [], {}
        return solve(residuals=r, iterations_out=i), r, i

    # a device-stopped solve reads the host once: each inner solve of
    # solve_refined (CG or GMRES; or the path's own solve) once
    reads = path.get("reads", lambda it: len(it["inner"]))
    forms_gate(phase, tag, run, reads, ml, reps, ((x, res, it), counts),
               kw.get("cycle", "V"), op_profile=True)
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
        ("elasticity", A_el, B_el, {"max_coarse": 50}, ("bell_apply",),
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
    """The elasticity cycle's block work on its fine level, by its device
    operations: one ``bspmv`` (one K7 launch), the torch formula of a
    block Gauss-Seidel color pass that K7's pass replaced (a full product,
    the batched product with the inverted diagonal blocks and the masked
    update) and the level's whole pre-smoothing sweep (K7's passes).
    Prints each one's device time per call (L2-warm), its time with the
    host, and its device operations (``ops_per_call``, L2 flushed)."""
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


BELL_SRC = "pyamg_tpu_torch/csrc/bell_kernels.cu"


def k7_tolerance(L, x, mode, b=None, dinv=None, omega=1.0, mask=None):
    """Per output, how far K7 and its plain version may differ: each is a
    sum of m = width * bc products (and, for an update, br more terms and
    two adds), in float32 or float64 rounding, in different orders (the
    kernel's slot order with FMA, the einsum's library order), so each
    lies within gamma(m + br + 2) = k u / (1 - k u) of the magnitude of
    its terms (|A| |x| and |b| for the residual; |x| + |omega| |Dinv|
    (|b| + |A| |x|) for an update) from the exact value (the standard
    bound for a dot product); their difference within twice that, and
    within four times here."""
    import torch
    br, bc = L.blocksize
    f64 = torch.float64
    ax = torch.einsum("nwij,nwj->ni", L.a_vals.abs().to(f64),
                      x.abs().to(f64).reshape(L.nbc, bc)[L.a_cols])
    if mode != "apply":
        ax = ax + b.abs().to(f64).reshape(L.nb, br)
    if mode in ("gs_color", "jacobi"):
        ax = x.abs().to(f64).reshape(L.nb, br) + abs(omega) * torch.einsum(
            "nij,nj->ni", dinv.abs().to(f64), ax)
    u = torch.finfo(L.vals.dtype).eps / 2
    k = L.width * bc + br + 2
    return (4 * k * u / (1 - k * u) * ax).reshape(-1)


def k7_case(L, x, mode, tag, b=None, dinv=None, omega=1.0, group=None,
            mask=None):
    """K7 once against its plain version: every output within
    ``k7_tolerance``; a color pass leaves the other colors' rows of x bit
    for bit as they were, a masked sweep the rows off its mask.  One
    launch.  Returns the largest error over its tolerance."""
    import torch
    from pyamg_tpu_torch.ops import bell_kernels as bk
    x0 = x.clone()
    before = bk.bell_apply.launches
    got = bk.bell_apply(L, x0.clone() if mode == "gs_color" else x0, mode,
                        b=b, dinv=dinv, omega=omega, group=group, mask=mask)
    launched = bk.bell_apply.launches - before
    want = bk.bell_apply_plain(L, x0.clone(), mode, b=b, dinv=dinv,
                               omega=omega, group=group, mask=mask)
    torch.cuda.synchronize()
    tol = k7_tolerance(L, x0, mode, b, dinv, omega, mask)
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    ratio = float((err / tol.clamp_min(1e-300)).max())
    br = L.blocksize[0]
    kept = None
    if group is not None or mask is not None:
        upd = torch.zeros(L.nb, dtype=torch.bool, device=x.device)
        if group is not None:
            upd[L.rows(group)] = True
        else:
            upd = mask
        off = ~upd.repeat_interleave(br)
        kept = bool(torch.equal(got[off], x0[off]))
    print(f"bell: K7 {tag} {mode}{'' if group is None else f' color {group}'}"
          f"{' masked' if mask is not None else ''} {str(L.vals.dtype)[6:]}: "
          f"max |kernel - plain| {float(err.max()):.3e}, at most "
          f"{ratio:.3e} of its rounding bound; other rows unchanged bit for "
          f"bit {kept}; launches {launched}")
    check(ratio <= 1.0 and launched == 1 and kept in (None, True),
          f"K7 {tag} {mode} disagrees with its plain version")
    return ratio


def random_bell(rng, nb, blocksize, mb, density=4):
    """A random host BELL of ``nb`` x ``mb`` blocks of ``blocksize``,
    about ``density`` stored blocks a row; square: a symmetric pattern
    with every diagonal block."""
    import scipy.sparse as sp
    from pyamg_tpu_torch.sparse.matrix import bell_from_scipy
    br, bc = blocksize
    P = sp.random(nb, mb, density=density / mb, format="csr",
                  random_state=int(rng.integers(1 << 31)))
    if nb == mb:
        P = P + P.T + sp.eye(nb)
    P = P.tocsr()
    P.sort_indices()
    data = rng.standard_normal((P.nnz, br, bc)).astype(np.float32)
    return bell_from_scipy(sp.bsr_matrix((data, P.indices, P.indptr),
                                         shape=(nb * br, mb * bc)))


def k7_bytes(L, mode, rows, item):
    """Bytes a K7 launch reads and writes at least, each once: its rows'
    slots (a block and an int32 column each; the BELL's padding slots
    too, which it stores), x once, and its rows' b, Dinv and y."""
    br, bc = L.blocksize
    n = rows * L.width * (br * bc * item + 4) + L.nbc * bc * item + \
        rows * br * item
    if mode != "apply":
        n += rows * br * item
    if mode in ("gs_color", "jacobi"):
        n += rows * br * br * item
    return n


def bell_phase(dev, row, n=708, seed=SEED):
    """The ``bell:`` phase: K7 (``ops/bell_kernels.py``) at the shapes of
    the benchmark's ``elastsa_708sq.rhs`` cell.  Its hierarchy is built as
    the cell builds it (PyAMG's operator from ``amg_bench/reference/
    elasticity.py``, SA with the rigid-body modes, ``max_coarse=50``,
    float32, the cell's prep steps); every K7 mode against its plain
    version (``k7_case``) on levels 0-2 (apply, residual, Jacobi on every
    row and on a mask, a color pass of every color), float64 on level 0,
    P0, R0 and P1, and the kernel of runtime block sides on 4 x 4, 2 x 5,
    9 x 9, 4 x 10 and 11 x 11 blocks (random BELLs, the square ones'
    color passes too); one solve as the cell runs it, its true residual and its
    launches (every product and pass one K7 launch); and the time rows
    (``row``: ``kernel_row``) of level 0's modes, a color pass on levels
    1 and 2, and P0, R0 and P1, beside today's torch formula of each (the
    library column).  Returns the rows."""
    import dataclasses
    import torch
    from amg_bench.reference.elasticity import operator
    from pyamg_tpu_torch import _trace
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.ops import bell_kernels as bk
    from pyamg_tpu_torch.relaxation.relaxation import (block_pattern,
                                                       make_coloring)
    from pyamg_tpu_torch.sparse.matrix import BELL, bell_from_scipy
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    S, B = operator(n)
    A64 = bell_from_scipy(S)
    ml = smoothed_aggregation_solver(A64.astype(np.float32), B=B,
                                     max_coarse=50)
    ml.compress_stencils()
    ml.collapse_coarse(max_n=4096, device=dev)
    ml.enable_ds_refinement(A64, device=dev)
    ml.to_device(dev)
    print(f"bell: {n}^2 elasticity set up and placed in "
          f"{time.perf_counter() - t0:.1f} s: levels "
          f"{[(l.A.shape[0], l.A.blocksize) for l in ml.levels]}")

    def vec(m, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(m), device=dev).to(dtype)

    cases = {}
    for i, lvl in enumerate(ml.levels[:-1][:3]):
        A = lvl.A
        kind, sopts, params = lvl.pre
        check(isinstance(A, BELL) and kind == "block_gauss_seidel",
              f"level {i} is not a BELL with block Gauss-Seidel")
        colors, D = params["colors"], params["Dinv"]
        # the layout to_device built: grouped by the coloring that both
        # smoothers of the level share
        L = bk.layout_of(A)
        check(L.colors is colors is lvl.post[2]["colors"] and
              len(L.groups) == sopts["ncolors"],
              f"level {i}: its K7 layout is not grouped by its smoothers' "
              f"coloring")
        x, b = vec(A.shape[1]), vec(A.shape[0])
        tag = f"A{i} ({A.n_block_rows} block rows, {A.blocksize[0]}x" \
              f"{A.blocksize[1]}, width {A.width})"
        k7_case(L, x, "apply", tag)
        k7_case(L, x, "residual", tag, b=b)
        k7_case(L, x, "jacobi", tag, b=b, dinv=D, omega=0.7)
        mask = torch.as_tensor(np.arange(A.n_block_rows) % 3 == 0,
                               device=dev)
        k7_case(bk.build_layout(A), x, "jacobi", tag, b=b, dinv=D,
                omega=0.7, mask=mask)
        for c in range(sopts["ncolors"]):
            k7_case(L, x, "gs_color", tag, b=b, dinv=D, omega=1.0, group=c)
        cases[f"A{i}"] = (A, L, x, b, D, colors)
        if i == 0:
            A64d = dataclasses.replace(A, vals=A.vals.double())
            D64 = D.double()
            L64 = bk.build_layout(A64d, colors, sopts["ncolors"])
            x64, b64 = x.double(), b.double()
            k7_case(L64, x64, "apply", tag)
            k7_case(L64, x64, "gs_color", tag, b=b64, dinv=D64, group=0)
    for name, op in (("P0", ml.levels[0].P), ("R0", ml.levels[0].R),
                     ("P1", ml.levels[1].P)):
        if op is None:
            continue
        L = bk.layout_of(op)
        x = vec(op.shape[1])
        k7_case(L, x, "apply", f"{name} ({op.n_block_rows} block rows, "
                f"{op.blocksize[0]}x{op.blocksize[1]}, width {op.width})")
        cases[name] = (op, L, x, None, None, None)
    # the kernel of runtime block sides (no hierarchy here has them): in
    # registers up to 8 block rows, wider blocks 8 rows at a time with the
    # residual of a sweep through a work vector; a square pattern
    # symmetric, with its block coloring, so that its passes run too
    for (br, bc), nb in (((4, 4), 3000), ((2, 5), 2000), ((9, 9), 1500),
                         ((4, 10), 1500), ((11, 11), 700)):
        H = random_bell(rng, nb, (br, bc), nb if br == bc else nb // 2)
        G = H.to(dev)
        L = bk.layout_of(G)
        x = vec(G.shape[1])
        tag = f"random {br}x{bc} ({nb} block rows, width {G.width})"
        k7_case(L, x, "apply", tag)
        if br == bc:
            b = vec(G.shape[0])
            D = torch.as_tensor(rng.standard_normal((nb, br, br)) / br,
                                device=dev).float()
            k7_case(L, x, "residual", tag, b=b)
            k7_case(L, x, "jacobi", tag, b=b, dinv=D, omega=0.8)
            colors, nc = make_coloring(block_pattern(H))
            LC = bk.build_layout(G, torch.as_tensor(colors, device=dev), nc)
            for c in range(min(nc, 2)):
                k7_case(LC, x, "gs_color", tag, b=b, dinv=D, group=c)

    # one solve as the cell runs it: every block product and pass one
    # launch, and a true residual at tol
    bs = rng.standard_normal(S.shape[0])
    ml.solve_refined_device(bs, tol=1e-10, inner_maxiter=60, max_outer=20)
    _trace.reset()
    reset_kernel_launches()
    it = {}
    t0 = time.perf_counter()
    xs = ml.solve_refined_device(bs, tol=1e-10, inner_maxiter=60,
                                 max_outer=20, iterations_out=it)
    wall = time.perf_counter() - t0
    c = _trace.snapshot()["counters"]
    relres = float(np.linalg.norm(bs - S @ xs) / np.linalg.norm(bs))
    launches, products, passes = (c.get(k, 0) for k in (
        "bell_kernels.launches", "bell.products", "bell.gs_passes"))
    print(f"bell: {n}^2 solve {wall * 1e3:.1f} ms (warm, host clock), "
          f"iterations {it}, true relres {relres:.3e}, K7 launches "
          f"{launches} = {passes} color passes + {products} products")
    check(relres <= 1.01e-10 and launches == passes + products > 0,
          "bell: the solve missed tol or K7's launches are not its passes "
          "and products")
    per_solve = dict(bk.bell_apply.by_op)

    def launched(L, mode, rows):
        br, bc = L.blocksize
        return per_solve.get((mode, L.nb, L.nbc, rows, br, bc, L.width,
                              L.vals.element_size()), 0)

    # the time rows, L2 flushed; the library column is the torch formula
    # the same work ran before K7 (the einsum product, the full pass)
    rows = []

    def einsum_product(A, x):
        br, bc = A.blocksize
        return torch.einsum("nwij,nwj->ni", A.vals, x.reshape(
            A.n_block_cols, bc)[A.cols]).reshape(-1)

    def einsum_pass(A, x, b, D, omega, m=None):
        """The torch formula of a block smoother pass before K7: a full
        einsum product, the batched product with Dinv, a masked
        update."""
        nb, br = A.n_block_rows, A.blocksize[0]
        dx = torch.einsum("nij,nj->ni", D, (b - einsum_product(A, x))
                          .reshape(nb, br))
        if m is not None:
            dx = torch.where(m[:, None], dx, 0)
        return x + omega * dx.reshape(-1)

    def timed(name, L, mode, rows_n, fn, plain, library, item=4):
        br, bc = L.blocksize
        ops = 2 * rows_n * L.width * br * bc
        return row(name, "none", launched(L, mode, rows_n), 0.0, fn, plain,
                   library, k7_bytes(L, mode, rows_n, item), ops,
                   source=BELL_SRC, plain_reps=5, tag=name)

    A, L, x, b, D, colors = cases["A0"]
    nb = L.nb
    rows.append(timed("K7 bell_apply A0 apply", L, "apply", nb,
                      lambda: bk.bell_apply(L, x),
                      lambda: bk.bell_apply_plain(L, x),
                      lambda: einsum_product(A, x)))
    rows.append(timed("K7 bell_apply A0 residual", L, "residual", nb,
                      lambda: bk.bell_apply(L, x, "residual", b=b),
                      lambda: bk.bell_apply_plain(L, x, "residual", b=b),
                      lambda: b - einsum_product(A, x)))
    rows.append(timed("K7 bell_apply A0 jacobi", L, "jacobi", nb,
                      lambda: bk.bell_apply(L, x, "jacobi", b=b, dinv=D,
                                            omega=0.7),
                      lambda: bk.bell_apply_plain(L, x, "jacobi", b=b,
                                                  dinv=D, omega=0.7),
                      lambda: einsum_pass(A, x, b, D, 0.7)))
    for name in [a for a in ("A0", "A1", "A2") if a in cases]:
        A, L, x, b, D, colors = cases[name]
        n0 = L.groups[0][1]
        xc = x.clone()
        rows.append(timed(
            f"K7 bell_apply {name} gs_color (color 0, {n0} of {L.nb} block "
            f"rows)", L, "gs_color", n0,
            lambda L=L, xc=xc, b=b, D=D: bk.bell_apply(
                L, xc, "gs_color", b=b, dinv=D, group=0),
            lambda L=L, xc=xc, b=b, D=D: bk.bell_apply_plain(
                L, xc, "gs_color", b=b, dinv=D, group=0),
            lambda A=A, x=x, b=b, D=D, m=colors == 0: einsum_pass(
                A, x, b, D, 1.0, m)))
    for name in [a for a in ("A1", "A2", "P0", "R0", "P1") if a in cases]:
        A, L, x = cases[name][:3]
        rows.append(timed(f"K7 bell_apply {name} apply", L, "apply", L.nb,
                          lambda L=L, x=x: bk.bell_apply(L, x),
                          lambda L=L, x=x: bk.bell_apply_plain(L, x),
                          lambda A=A, x=x: einsum_product(A, x)))
    return rows


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
                        iterations_ok=(cg_near, "within 1 of its CG count"),
                        reads=lambda it: 1)
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
    from pyamg_tpu_torch.ops import bell_kernels as bk
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import dist_kernels as tk
    from pyamg_tpu_torch.ops import sell_kernels as sk
    return {k.__name__: k.launches
            for k in dk.KERNELS + sk.KERNELS + tk.KERNELS + bk.KERNELS}


def reset_kernel_launches():
    from pyamg_tpu_torch.ops import launch
    launch.reset_launch_counts()


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
    from pyamg_tpu_torch import _graph
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
        def solve(ml=ml, kw=cg8):
            res = []
            x, info = ml.solve(b, residuals=res, return_info=True, **kw)
            return x, res, info

        gate = forms_gate("parallel", f"{tag} {name} CG to 1e-8", solve,
                          ml=ml, reps=reps)
        med, per_solve, launched = (gate[k] for k in
                                    ("medians", "collectives", "launches"))
        print(f"parallel: {tag} {name} CG to 1e-8 warm median of {reps} "
              f"{med['device-stopped'] * 1e3:.3f} ms device-stopped (op by "
              f"op {med['op by op'] * 1e3:.3f} ms), collectives per solve "
              f"{per_solve}, kernel launches {launched}")
        check(all(v == 0 for v in launched.values()),
              f"{tag} {name}: a CUDA kernel launched: {launched}")
        if name != "unsharded":
            for what, kw in (("2 standalone cycles", sa2),
                             ("GMRES to 1e-8", dict(maxiter=20, tol=1e-8,
                                                    accel="gmres"))):
                forms_gate("parallel", f"{tag} {name} {what}",
                           functools.partial(solve, kw=kw), ml=ml, reps=reps)
        # profiled device-stopped (NCCL's collectives inside a WHILE body)
        # and one graph a step, whose kernels the profiler sees (it may
        # miss those inside a conditional node's body)
        print_profile(f"{tag} {name} CG to 1e-8 device-stopped",
                      *profiled(solve), top=8, phase="parallel")
        print_profile(f"{tag} {name} CG to 1e-8 per step",
                      *profiled(per_step(solve)), top=8, phase="parallel")
        # op by op: a one-rank group's collectives are copies, which the
        # trace names by their NCCL call only when they are dispatched
        def eager_solve():
            with _graph.eager():
                solve()

        nccl = nccl_kernels(led_in_ops(eager_solve, mesh.device))
        print(f"parallel: {tag} {name} NCCL device operations in a trace of "
              f"one solve (op by op) led in by {TRACE_LEAD_IN} small "
              f"operations {nccl} (collectives {per_solve}, the same in "
              f"every form)")
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


def dist_describe(hier):
    """The numbers of a ``DistHierarchy`` that the ``parallel2:`` gates read
    (``tests/jax_dist_setup_reference.describe``)."""
    lv = hier.levels
    return {"levels": len(lv), "n_loc": [int(L.n_loc) for L in lv],
            "W": [int(L.cols.shape[1]) for L in lv],
            "WP": [int(L.p_cols.shape[1]) for L in lv[:-1]],
            "WR": [int(L.r_cols.shape[1]) for L in lv[:-1]],
            "margins": list(hier.diagnostics["margins"]),
            "nagg": list(hier.diagnostics["nagg"]),
            "dropped": list(hier.diagnostics["dropped"]),
            "omega": [float(L.omega) for L in lv],
            "nnz": [L.nnz() for L in lv],
            "operator_complexity": hier.operator_complexity(),
            "coarse_n": int(hier.coarse_n)}


def _near(got, want, rel, absolute=0):
    return abs(got - want) <= max(rel * abs(want), absolute)


def gate_dist(tag, got, want, tol):
    """A distributed hierarchy against the JAX package's (``JAX_DIST``):
    exactly, what reads no value (levels, each level's n_loc and widths,
    level 0's margin, aggregates, dropped entries and stored entries, the
    coarse size); from level 1 on, where rho and rounding move Ac's
    values, within ``tol`` (a DIST_TOL entry); each omega and the
    operator complexity within ``tol`` too."""
    print(f"parallel2: {tag} levels {got['levels']}, n_loc {got['n_loc']}, "
          f"widths A {got['W']} P {got['WP']} R {got['WR']}, margins "
          f"{got['margins']}, aggregates {got['nagg']}, dropped "
          f"{got['dropped']}, nnz {got['nnz']}, omega "
          f"{[round(w, 6) for w in got['omega']]}, operator complexity "
          f"{got['operator_complexity']:.7f} (JAX package: margins "
          f"{want['margins']}, aggregates {want['nagg']}, dropped "
          f"{want['dropped']}, nnz {want['nnz']}, omega "
          f"{[round(w, 6) for w in want['omega']]}, operator complexity "
          f"{want['operator_complexity']:.7f})")
    for k in ("levels", "n_loc", "W", "WP", "WR", "coarse_n"):
        check(got[k] == want[k], f"{tag}: {k} {got[k]}, the JAX package's "
                                 f"{want[k]}")
    for k in ("margins", "nagg", "dropped", "nnz"):
        check(len(got[k]) == len(want[k]) and got[k][0] == want[k][0],
              f"{tag}: level 0 {k} {got[k][:1]}, the JAX package's "
              f"{want[k][:1]}")
        for i, (g, w) in enumerate(zip(got[k][1:], want[k][1:]), 1):
            last = k == "margins" and i == len(got[k]) - 1
            rel, absolute = tol["margins_coarsest" if last else k]
            check(_near(g, w, rel, absolute),
                  f"{tag}: level {i} {k} {g}, the JAX package's {w} (tol "
                  f"{rel:g} relative or {absolute})")
    for i, (g, w) in enumerate(zip(got["omega"], want["omega"])):
        rel = tol["omega_coarsest" if i == len(got["omega"]) - 1
                  else "omega"]
        check(_near(g, w, rel), f"{tag}: level {i} omega {g}, the JAX "
                                f"package's {w} (tol {rel:g} relative)")
    check(_near(got["operator_complexity"], want["operator_complexity"],
                tol["operator_complexity"]),
          f"{tag}: operator complexity {got['operator_complexity']}, the "
          f"JAX package's {want['operator_complexity']}")


def gate_dist_solve(tag, solve, got, want, S, b, x):
    """Iterations within 1 of the JAX package's (FGMRES: restart cycles
    within 1), relres below the tolerance where the JAX package reached
    it (else within 2x of its), and the true relative residual (float64,
    scipy, the unpadded operator) within 2x of the JAX package's."""
    it, relres = got
    n = S.shape[0]
    xs = x.double().cpu().numpy()[:n]
    true = float(np.linalg.norm(b[:n] - S @ xs) / np.linalg.norm(b[:n]))
    tol = want["solve"]["tol"]
    step = want["solve"].get("restart", 1)
    print(f"parallel2: {tag} {solve}: {it} iterations, relres {relres:.4e}, "
          f"true relative residual {true:.4e} (JAX package "
          f"{want['iterations']}, {want['relres']:.4e}, "
          f"{want['true_relres']:.4e})")
    check(abs(it - want["iterations"]) <= step,
          f"{tag}: {it} iterations, the JAX package's {want['iterations']}")
    if want["relres"] < tol:
        check(relres < tol, f"{tag}: relres {relres:.3e} above {tol:g}")
    else:
        check(relres <= 2 * want["relres"],
              f"{tag}: relres {relres:.3e}, the JAX package's "
              f"{want['relres']:.3e}")
    check(np.isfinite(true) and true <= 2 * want["true_relres"],
          f"{tag}: true relative residual {true:.3e}, twice the JAX "
          f"package's is {2 * want['true_relres']:.3e}")
    return true


def dist_flow(tag, mesh, n, want, setup="sa", smoother="jacobi", reps=5,
              timed=False, keep=False, row=None, krows=None):
    """One distributed flow of the ``parallel2:`` phase: 2-D Poisson n^2,
    float32, on ``mesh``, the power iterations from ``hashed_start`` (as
    the JAX reference), gated against ``want``; with ``timed`` the setup
    seconds by level, the warm median of ``reps`` solves, one profiled
    solve, the peak memory beside the port's model and the collectives
    per solve.  Every K6 product of the hierarchy against its plain
    version (``k6_gate``; with ``row``, timed, its rows added to
    ``krows``), K6's launches a CG, and whether two solves of one b give
    one x bit for bit.  Returns (hierarchy, b, result of the cold
    solve)."""
    import torch
    import scipy.sparse as sp
    from pyamg_tpu_torch.parallel import (StackedMesh, dist_stencil_grid,
                                          distributed_classical_setup,
                                          distributed_sa_setup, partition,
                                          scale_model)
    from pyamg_tpu_torch.parallel.dist_setup import hashed_start
    dev = mesh.device
    st = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    cols, vals, ok, n_loc = dist_stencil_grid(st, (n, n), mesh,
                                              dtype=torch.float32)
    cu = want["coarsen_until"]
    if setup == "sa":
        hier = distributed_sa_setup(cols, vals, ok, n_loc, mesh,
                                    coarsen_until=cu, smoother=smoother,
                                    rho_start=hashed_start)
    else:
        hier = distributed_classical_setup(cols, vals, ok, n_loc, mesh,
                                           coarsen_until=cu,
                                           rho_start=hashed_start)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    got = dist_describe(hier)
    secs = hier.diagnostics["seconds"]
    print(f"parallel2: {tag} setup {t_setup:.3f} s (rows {n * n}, "
          f"{mesh.size} ranks of {n_loc} rows on {dev}); seconds by level "
          f"{[round(t, 4) for t in secs]}")
    line = f"parallel2: {tag} peak device memory of the setup " \
        f"{peak / 1e9:.3f} GB"
    if setup == "sa":
        # the model replays the SA setup's shape laws only
        model = scale_model.summarize(n * n, 5, mesh.size,
                                      levels=got["levels"])
        local = mesh.size if isinstance(mesh, StackedMesh) else 1
        line += (f"; the port's scale_model predicts "
                 f"{model['total_setup_gb'] * local:.3f} GB ({local} "
                 f"rank(s) of {model['total_setup_gb']:.3f} GB: steady "
                 f"{model['steady_state_gb']:.3f}, setup peak "
                 f"{model['setup_peak_gb']:.3f}, vectors "
                 f"{model['solve_vectors_gb']:.3f}; the model leaves out "
                 f"the sorts' work arrays)")
    print(line)
    gate_dist(tag, got, want, DIST_TOL[setup])
    # the unpadded operator, float64, from the rows of level 0
    L0 = hier.levels[0]
    c, v, o = (a.cpu().numpy() for a in (L0.cols, L0.vals, L0.ok))
    rows = np.repeat(np.arange(c.shape[0]), c.shape[1])
    m = o.ravel()
    S = sp.csr_matrix((v.ravel()[m].astype(np.float64),
                       (rows[m], c.ravel()[m])),
                      shape=(c.shape[0], L0.n))[:n * n, :n * n]
    b = np.random.default_rng(0).standard_normal(L0.n)
    b[n * n:] = 0.0
    kw = want["solve"]
    solve_name = "solve_cg" if setup == "sa" else "solve_fgmres"

    def solve():
        return getattr(hier, solve_name)(b, **kw)

    reset_kernel_launches()
    partition.reset_counts()
    x, relres, it = solve()
    launched = kernel_launches()
    k6_by_op = counters()["dist_slice_apply"][1]
    colls = dict(partition.COUNTS)
    true = gate_dist_solve(tag, solve_name, (it, relres), want, S, b, x)
    print(f"parallel2: {tag} kernel launches around the cold solve "
          f"{launched}; collectives of the solve {colls}")
    k6 = launched.pop("dist_slice_apply")
    check(all(v == 0 for v in launched.values()) and k6 > 0,
          f"{tag}: a K1-K5 kernel launched on the distributed path, or no "
          f"K6: {launched}, K6 {k6}")
    if setup == "sa" and smoother == "jacobi":
        # a V-cycle is 7 products on each level above the dense one (two
        # sweeps, residual, R, correction, two sweeps); CG runs it once
        # before its loop and once an iteration, beside A p
        cyc = 7 * (len(hier.levels) - 1)
        check(k6 == cyc * (it + 1) + it,
              f"{tag}: {k6} K6 launches for {it} CG iterations, want "
              f"{cyc * (it + 1) + it}")
    x2 = solve()[0]
    print(f"parallel2: {tag} two solves of one b give the same x bit for "
          f"bit: {bool(torch.equal(x, x2))}")
    got_rows = k6_gate(tag, hier, k6_by_op, row)
    if krows is not None:
        krows += got_rows
    if timed:
        med = forms_gate("parallel2", f"{tag} {solve_name}", solve,
                         reps=reps)["medians"]
        print(f"parallel2: {tag} {solve_name} warm median of {reps} "
              f"{med['device-stopped'] * 1e3:.3f} ms device-stopped, "
              f"{med['per step'] * 1e3:.3f} ms per step, "
              f"{med['op by op'] * 1e3:.3f} ms op by op")
        # profiled one graph a step, whose kernels the profiler sees
        print_profile(f"{tag} {solve_name} (one graph a step)",
                      *profiled(per_step(solve)), top=8, phase="parallel2")
    return hier, b, (x, relres, it, true)


def k6_products(hier):
    """Every K6 product of ``hier``'s V-cycle: (level, name, layout,
    stored entries it reads, the mode's vectors)."""
    from pyamg_tpu_torch.parallel.dist_setup import exchange_of
    ex = exchange_of(hier.mesh)
    out = []
    for i, S in enumerate(hier._slices(ex)):
        L = hier.levels[i]
        A, P, R = (int(a.sum()) for a in (L.ok, L.p_ok, L.r_ok))
        out += [(i, "A apply", S.A, A, ()),
                (i, "A residual", S.A, A, ("b",)),
                (i, "A jacobi", S.A, A, ("x", "b", "w")),
                (i, "A jacobi0", S.A, 0, ("b", "w")),
                (i, "P correct", S.P, P, ("x",)),
                (i, "R apply", S.R, R, ())]
    return out


def k6_gate(tag, hier, by_op, row=None):
    """K6 on every product of ``hier``'s V-cycle in its mode, against the
    plain version on the card, bit for bit (random src and vectors); with
    ``row`` (``kernel_row`` with its flush) each product's device time
    beside its bound: stored entries (4-byte column and value) read once,
    src, the mode's vectors and y once each, and torch.sparse's CSR
    product of the same entries as the library call; its launches a solve
    from ``by_op`` (K6's counts of one cold solve).  Returns the rows."""
    import torch
    from pyamg_tpu_torch.ops import dist_kernels as tk
    gen = torch.Generator(device=hier.coarse_dense.device).manual_seed(7)
    rows, worst = [], 0
    for lvl, name, L, stored, needs in k6_products(hier):
        dt, dev = L.vals.dtype, L.vals.device

        def rand(n):
            return torch.randn(n, generator=gen, device=dev, dtype=dt)
        mode = name.split()[1] if name != "R apply" else "apply"
        src = rand(L.src_len) if mode != "jacobi0" else None
        vecs = {k: rand(L.rows) for k in needs}
        before = tk.dist_slice_apply.launches
        got = tk.dist_slice_apply(L, src, mode, **vecs)
        launched = tk.dist_slice_apply.launches - before
        want = tk.dist_slice_apply_plain(L, src, mode, **vecs)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        err = float((got - want).abs().max()) if L.rows else 0.0
        worst = max(worst, err)
        check(same and launched == 1,
              f"{tag}: K6 level {lvl} {name} differs from its plain version "
              f"(max_abs_err {err:.3e}) or took {launched} launches")
        if row is None:
            continue
        es = L.vals.element_size()
        nbytes = stored * (4 + es) + (L.rows * (1 + len(vecs)) + (
            0 if src is None else L.src_len)) * es
        if src is None:         # jacobi0: no product, no library call
            rows.append(row(
                f"K6 {tag} level {lvl} {name}", "none", by_op.get(
                    (L.rows, L.width_sum, mode), 0), err,
                lambda: tk.dist_slice_apply(L, None, mode, **vecs),
                lambda: tk.dist_slice_apply_plain(L, None, mode, **vecs),
                None, nbytes, 2 * L.rows,
                source="pyamg_tpu_torch/csrc/dist_kernels.cu",
                plain_reps=5, tag=f"K6 {tag} level {lvl} {name} ({L.rows} "
                                  f"rows)"))
            continue
        keep = L.vals != 0
        slot = torch.arange(L.vals.numel(), device=dev)
        r_of = (torch.repeat_interleave(
            torch.arange(L.slices, device=dev),
            (L.sptr[1:] - L.sptr[:-1])) * tk.SLICE + slot % tk.SLICE)
        order = torch.argsort(r_of[keep], stable=True)
        crow = torch.zeros(L.rows + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(r_of[keep],
                                               minlength=L.rows), 0)
        lib = torch.sparse_csr_tensor(crow, L.cols[keep][order].long(),
                                      L.vals[keep][order],
                                      (L.rows, L.src_len))
        rows.append(row(
            f"K6 {tag} level {lvl} {name}",
            "none (pyamg_tpu/parallel/dist_setup.py:87-125, jnp gathers)",
            by_op.get((L.rows, L.width_sum, mode), 0), err,
            lambda: tk.dist_slice_apply(L, src, mode, **vecs),
            lambda: tk.dist_slice_apply_plain(L, src, mode, **vecs),
            lambda: lib @ src, nbytes, 2 * stored,
            source="pyamg_tpu_torch/csrc/dist_kernels.cu", plain_reps=5,
            tag=f"K6 {tag} level {lvl} {name} ({L.rows} rows, {stored} "
                f"stored in {tk.SLICE * L.width_sum} slots)"))
    print(f"parallel2: {tag} K6 on every product of {len(hier.levels) - 1} "
          f"levels in its mode equals its plain version bit for bit "
          f"(max_abs_err {worst:.3e})")
    return rows


def same_dist(tag, h1, r1, h2, r2):
    """Two hierarchies and their CGs bit for bit: every array of every
    level, each omega, the coarse pinv, x, relres and iterations."""
    worst = 0.0
    fields = ("cols", "vals", "ok", "Dinv", "p_cols", "p_vals", "p_ok",
              "r_cols", "r_vals", "r_ok", "cheb")
    check(len(h1.levels) == len(h2.levels),
          f"{tag}: {len(h1.levels)} and {len(h2.levels)} levels")
    pairs = [(h1.coarse_dense, h2.coarse_dense), (r1[0], r2[0])]
    for L1, L2 in zip(h1.levels, h2.levels):
        check(L1.omega == L2.omega and L1.g == L2.g,
              f"{tag}: omega or margin differ")
        for f in fields:
            a, w = getattr(L1, f), getattr(L2, f)
            check((a is None) == (w is None), f"{tag}: {f} present in one")
            if a is not None:
                pairs.append((a, w))
    for a, w in pairs:
        check(a.shape == w.shape and a.dtype == w.dtype,
              f"{tag}: shapes or types differ")
        d = (a.double() - w.double()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    print(f"parallel2: {tag}: {len(pairs)} arrays, max_abs_err {worst:.3e}; "
          f"CG {r1[2]} / {r2[2]} iterations, relres {r1[1]:.6e} / "
          f"{r2[1]:.6e}")
    check(worst == 0 and r1[1:3] == r2[1:3],
          f"{tag}: the two forms differ (max_abs_err {worst:.3e})")


def parallel2_phase(dev, want=None, full=1414, cl=500, small=32, reps=5,
                    row=None):
    """The ``parallel2:`` phase, the distributed setup and its solves
    (``pyamg_tpu_torch.parallel.dist_setup``) on 2-D Poisson, float32,
    against the JAX package's runs (``want``, JAX_DIST): (1) the dryrun's
    two flows at ``small``^2 on 8 ranks in this process; (2) SA at
    ``full``^2 on 8 ranks in this process, Jacobi and Chebyshev, timed;
    (3) the same SA on a one-rank NCCL group, timed, with its collectives;
    (4) classical AMG with FGMRES at ``cl``^2 on 8 ranks, timed; (5) flow
    3 again on a one-rank ``StackedMesh``: bit for bit equal to flow 3.
    No K1-K5 launch on any; K6 on every product of every flow equals its
    plain version bit for bit, and with ``row`` (``kernel_row`` with its
    flush) flow 3's products are timed.  Returns those kernel rows."""
    import torch
    import torch.distributed as dist
    from pyamg_tpu_torch.parallel import StackedMesh, make_row_mesh
    want = JAX_DIST if want is None else want
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    stacked = StackedMesh(8, dev)
    t0 = time.perf_counter()
    dist_flow(f"sa{small}", stacked, small, want[f"sa{small}"])
    dist_flow(f"cl{small}", stacked, small, want[f"cl{small}"],
              setup="classical")
    print(f"parallel2: flow 1 {time.perf_counter() - t0:.2f} s")
    for name, sm in ((f"sa{full}", "jacobi"), (f"cheb{full}", "chebyshev")):
        t0 = time.perf_counter()
        dist_flow(name, stacked, full, want[name], smoother=sm, reps=reps,
                  timed=True)
        torch.cuda.empty_cache()
        print(f"parallel2: flow 2 {name} {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    kw = {}
    if dev.type == "cuda":
        kw = {"device_id": dev}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **kw)
    try:
        mesh = make_row_mesh(1, device=dev)
        print(f"parallel2: one-rank {dist.get_backend()} group on "
              f"{mesh.device}: the ring carries nothing (no neighbour), "
              f"the sums gather one partial each")
        rows = []
        h3, _, r3 = dist_flow(f"sa{full}r1", mesh, full, want[f"sa{full}r1"],
                              reps=reps, timed=True, row=row, krows=rows)
    finally:
        dist.destroy_process_group()
    print(f"parallel2: flow 3 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    h5, _, r5 = dist_flow(f"sa{full}r1", StackedMesh(1, dev), full,
                          want[f"sa{full}r1"])
    same_dist(f"flow 5: one-rank NCCL group against one-rank StackedMesh "
              f"at {full}^2", h3, r3, h5, r5)
    del h3, h5
    torch.cuda.empty_cache()
    print(f"parallel2: flow 5 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dist_flow(f"cl{cl}", stacked, cl, want[f"cl{cl}"], setup="classical",
              reps=reps, timed=True)
    print(f"parallel2: flow 4 {time.perf_counter() - t0:.2f} s")
    return rows


def classical2_paths(dev, n_el=100, n_c=256):
    """The ``classical2:`` phase's paths, built on the host with the port's
    entry points as ``tests/jax_classical2_reference.py`` builds the JAX
    package's, uncompressed, placed on ``dev``: BAIR, ``air_solver(A,
    max_coarse=20)`` on 2-D linear elasticity n_el^2 (BSR 2 x 2, float64,
    the default F/C Jacobi post-smoother); CRS, ``ruge_stuben_solver(A,
    max_coarse=10)`` and CAIR, ``air_solver(A, max_coarse=20)`` on
    ``poisson((n_c, n_c)) * (1 + 0.5j)`` in complex128; b from
    ``default_rng(0)``.  Each a dict: name, scipy A, ml, b, setup
    seconds; BAIR also ``ml_block``, the same hierarchy with block Jacobi
    post-smoothing."""
    import copy
    from pyamg_tpu_torch.classical import air_solver, ruge_stuben_solver
    from pyamg_tpu_torch.gallery import linear_elasticity, poisson
    from pyamg_tpu_torch.relaxation.smoothing import change_smoothers
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    A_el, _ = linear_elasticity((n_el, n_el), format="bsr")
    S = to_scipy(poisson((n_c, n_c))).tocsr().astype(np.complex128) * \
        (1 + 0.5j)
    b_c = np.random.default_rng(0).standard_normal(S.shape[0]).astype(
        np.complex128)
    specs = [("BAIR", A_el, A_el.tocsr(),
              np.random.default_rng(0).standard_normal(A_el.shape[0]),
              lambda A: air_solver(A, max_coarse=20)),
             ("CRS", S, S, b_c, lambda A: ruge_stuben_solver(A,
                                                             max_coarse=10)),
             ("CAIR", S, S, b_c, lambda A: air_solver(A, max_coarse=20))]
    out = []
    for name, A, S_, b, make in specs:
        t0 = time.perf_counter()
        ml = make(A)
        path = {"name": name, "S": S_, "b": b,
                "setup_s": time.perf_counter() - t0}
        if name == "BAIR":
            # the JAX package's reference smoother, on a host copy (a
            # smoother's setup reads the host operators)
            block = copy.deepcopy(ml)
            change_smoothers(block, None, "block_jacobi")
            path["ml_block"] = block.to_device(dev)
        path["ml"] = ml.to_device(dev)
        out.append(path)
    return out


def classical2_describe(ml):
    """What ``tests/jax_classical2_reference.py`` prints of a hierarchy."""
    return {"rows": [int(lvl.A.shape[0]) for lvl in ml.levels],
            "blocksizes": [list(getattr(lvl.A, "blocksize", (1, 1)))
                           for lvl in ml.levels],
            "operator_complexity": ml.operator_complexity(),
            "layouts": [[type(getattr(lvl, a, None)).__name__ for a in "APR"]
                        for lvl in ml.levels]}


def classical2_phase(dev, want=None, n_el=100, n_c=256, reps=3):
    """The ``classical2:`` phase: block AIR and complex RS/AIR
    (``classical2_paths``).  Each hierarchy is gated against ``want``
    (JAX_CLASSICAL2: rows, blocksizes and layouts equal, operator
    complexity within 1e-6) before any solve.  Each path is solved by
    GMRES to 1e-8 (BAIR twice: with its default F/C Jacobi, held to a
    preconditioned residual below tol and a true one below 1e-4, not to
    the JAX package, which raises there; then with block Jacobi, as the
    JAX package's reference), and by 10 cycles of standalone cycling,
    device-stopped, one host sync; every solve equal in its three forms
    (``forms_gate``), with no K1-K6 launch; GMRES's iterations within
    one of the JAX package's, its preconditioned residual below tol and,
    on the complex paths, its true one at most twice the JAX package's."""
    want = JAX_CLASSICAL2 if want is None else want
    for path in classical2_paths(dev, n_el, n_c):
        name, ml, S, b = (path[k] for k in ("name", "ml", "S", "b"))
        ref = want[name]
        d = classical2_describe(ml)
        print(f"classical2: {name} setup {path['setup_s']:.2f} s, rows "
              f"{d['rows']}, blocksizes {d['blocksizes']}, operator "
              f"complexity {d['operator_complexity']!r} (JAX package "
              f"{ref['operator_complexity']!r}), layouts {d['layouts']}, "
              f"{ml.levels[0].A.dtype}")
        check(all(d[k] == ref[k] for k in ("rows", "blocksizes", "layouts"))
              and abs(d["operator_complexity"] - ref["operator_complexity"])
              <= 1e-6, f"{name}: the hierarchy differs from the JAX "
                       f"package's")

        def gmres(ml=ml, b=b):
            res = []
            x, info = ml.solve(b, tol=1e-8, accel="gmres", residuals=res,
                               return_info=True)
            return x, res, info

        def standalone(ml=ml, b=b):
            res = []
            x, info = ml.solve(b, tol=1e-8, maxiter=10, residuals=res,
                               return_info=True)
            return x, res, info

        launched = forms_gate("classical2", f"{name} standalone, 10 cycles",
                              standalone, ml=ml, reps=0)["launches"]
        check(all(v == 0 for k, v in launched.items() if k != "bell_apply"),
              f"{name}: a kernel launched: {launched}")
        solves = [("GMRES", ml)]
        if name == "BAIR":
            solves = [("GMRES, F/C Jacobi (default)", ml),
                      ("GMRES, block Jacobi", path["ml_block"])]
        for what, m in solves:
            run = functools.partial(gmres, m)
            gate = forms_gate("classical2", f"{name} {what}", run, ml=m,
                              reps=reps)
            (x, res, _), launched = gate["result"], gate["launches"]
            x = np.asarray(x.cpu())
            its = len(res) - 1
            pre = res[-1] / res[0]
            true = float(np.linalg.norm(b - S @ x) / np.linalg.norm(b))
            print(f"classical2: {name} {what}: iterations {its} (JAX package "
                  f"{ref['iterations']}), preconditioned relres {pre:.3e}, "
                  f"true relres {true:.3e} (JAX package "
                  f"{ref['true_relres']:.3e}), warm median of {reps} "
                  f"{gate['medians']['device-stopped'] * 1e3:.3f} ms, "
                  f"launches {launched}")
            check(all(v == 0 for k, v in launched.items()
                      if k != "bell_apply"),
                  f"{name}: a kernel launched: {launched}")
            check(x.shape == b.shape and np.isfinite(x).all() and pre < 1e-8,
                  f"{name} {what}: preconditioned relres {pre:.3e} not "
                  f"below 1e-8")
            if what.startswith("GMRES, F/C"):
                check(true < 1e-4, f"{name}: true relres {true:.3e}")
            else:
                check(abs(its - ref["iterations"]) <= 1,
                      f"{name} {what}: {its} iterations, the JAX package "
                      f"{ref['iterations']}")
            if name != "BAIR":
                check(true <= 2 * ref["true_relres"],
                      f"{name}: true relres {true:.3e} above twice the JAX "
                      f"package's")


def device_section(dev):
    """The card's name and power limit (nvidia-smi), the versions, the
    kernels' build (one nvcc a source, started together) with each
    kernel's registers, shared memory, stack frame and spills, and the
    SWITCH probe of ``csrc/graph_cond.cu``: (the nvidia-smi line, SMs)."""
    import torch
    from pyamg_tpu_torch import _graph
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
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
    got, tally = _graph.probe_switch(dev)
    print(f"device: SWITCH probe (csrc/graph_cond.cu): bodies wrote {got} "
          f"for the index 0, 1, 2, 3 (want [1, 2, 3, 0]), tally {tally}")
    check(got == [1, 2, 3, 0] and tally == [1, 1, 1],
          "the card runs no SWITCH node as built")
    return card, sms


def grid_rows(N, max_coarse=10):
    """The rows of each level of grid SA on 2-D Poisson N^2 before the
    coarse collapse: a level aggregates 3 x 3 points (a side of ceil(side
    / 3)) until it has at most ``max_coarse`` rows.  This is the JAX
    package's rule (``tests/test_torch_scale.py`` holds it to the JAX
    package's hierarchies at 49^2 and 193^2)."""
    sides = [N]
    while sides[-1] ** 2 > max_coarse:
        sides.append(-(-sides[-1] // 3))
    return [s * s for s in sides]


def timed(steps, name, fn):
    """``fn()``, its seconds recorded as ``steps[name]``."""
    t0 = time.perf_counter()
    out = fn()
    steps[name] = time.perf_counter() - t0
    return out


def scale_host_setup(n, conn):
    """The host steps of the ``scale:`` phase's setup, run in a process of
    their own (``ScaleSetup``) while the earlier phases use the card: 2-D
    Poisson n^2, its float32 copy, grid SA and ``compress_stencils()``,
    each timed.  Sends ("ok", (A64, A32, ml, seconds by step, (levels,
    operator complexity before the collapse))) or ("error", traceback)
    through ``conn`` (``send_large``)."""
    import traceback
    try:
        import torch
        from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
        from pyamg_tpu_torch.gallery import poisson
        torch.set_num_threads(1)
        steps = {}
        A64 = timed(steps, "poisson", lambda: poisson((n, n)))
        A32 = timed(steps, "astype", lambda: A64.astype(np.float32))
        ml = timed(steps, "smoothed_aggregation_solver",
                   lambda: smoothed_aggregation_solver(
                       A32, aggregate=("grid", {}), max_coarse=10))
        full = (len(ml.levels), ml.operator_complexity())
        timed(steps, "compress_stencils", ml.compress_stencils)
        msg = ("ok", (A64, A32, ml, steps, full))
    except BaseException:
        msg = ("error", traceback.format_exc())
    send_large(conn, msg)
    conn.close()


PIPE_CHUNK = 1 << 20


def send_large(conn, obj):
    """Send ``obj`` through ``conn`` (``recv_large``): its pickle with the
    arrays' bytes left out, and their sizes, as one message; then each
    array's bytes written raw.  One ``Connection`` message of gigabytes
    is read 64 KB at a time into new buffers of all that remains (10 s
    for 2.5 GB on the development host, where this takes 5.6)."""
    import pickle
    buffers = []
    meta = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    views = [b.raw() for b in buffers]
    conn.send((meta, [v.nbytes for v in views]))
    fd = conn.fileno()
    for v in views:
        off = 0
        while off < v.nbytes:
            off += os.write(fd, v[off:off + PIPE_CHUNK])


def recv_large(conn):
    """What ``send_large`` sent: each array read into a buffer made up
    front, which the unpickled array then uses in place."""
    import pickle
    meta, sizes = conn.recv()
    fd, bufs = conn.fileno(), []
    for size in sizes:
        buf = bytearray(size)
        view, off = memoryview(buf), 0
        while off < size:
            got = os.readv(fd, [view[off:off + PIPE_CHUNK]])
            check(got > 0, "the scale: setup process closed its pipe early")
            off += got
        bufs.append(buf)
    return pickle.loads(meta, buffers=bufs)


class ScaleSetup:
    """``scale_host_setup`` in a spawned process (it holds no CUDA
    state), started at once; ``result()`` waits for it.  The process is
    a daemon, so a failing script does not wait for it."""

    def __init__(self, n=SCALE_N):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=scale_host_setup, args=(n, child),
                                daemon=True)
        self.proc.start()
        child.close()

    def result(self):
        status, out = recv_large(self.conn)
        self.proc.join()
        check(status == "ok", f"the scale: host setup failed:\n{out}")
        return out


def scale_phase(dev, sms, rng, setup, n=SCALE_N, want=None, reps=5):
    """The ``scale:`` phase: the JAX package's two 10M-unknown single-chip
    configurations, at full size on the card.

    (a) ``benchmarks/bench_10m_solve.py:31-67`` through the port's entry
    points, each step timed: 2-D Poisson n^2 (float64), its float32 copy,
    ``smoothed_aggregation_solver(aggregate=("grid", {}), max_coarse=10)``
    and ``compress_stencils()`` on the host in ``setup``'s process (a
    ``ScaleSetup``, started before the earlier phases so that its
    minutes of host work run beside them), then
    ``collapse_coarse(max_n=4096)``, ``enable_ds_refinement(A64)`` and
    ``to_device()`` here.  Before any solve the
    hierarchy is gated: its levels before and after the collapse and its
    operator complexity (four digits) against ``want`` (JAX_SCALE), its
    rows against ``grid_rows``, every active level a DIA (5 diagonals on
    level 0, 9 below) with PhaseStencil transfers.  K1 and K2 (each
    level's own sweep) run on every DIA level of the cycle against their
    plain versions to 0 (``path_kernels``).  Then
    ``solve_refined_device(b, tol=1e-10, inner_tol=1e-5, inner_maxiter=40,
    max_outer=10)``, b from ``default_rng(2022)``, is driven as a user
    drives it (``drive_path``): the counts set to 0 just before the cold
    solve and read just after (K1 and K2 per level), the outer and inner
    iterations within 1 of ``want``'s, the true relative residual (float64,
    scipy) below 1e-10, ``reps`` warm solves, one profiled one graph a
    step, the three forms bit for bit with one host sync device-stopped.
    The peak device memory and the bytes the placed hierarchy holds are
    printed.

    (b) ``benchmarks/bench_sell_scale.py:25-46`` on the same float32
    operator: ``sell_from_ell(A, k_choices=(4,))``, a square plan in the
    K4 regime with JAX_SELL_SCALE's stored entries and passes; one
    ``sell_spmv`` within 1e-6 x max |y| of the plain version; the
    script's loop of 20 products ``y = S y / 1.0001`` from x of
    ``default_rng(0)``, through the wrapper with the counts set to 0 just
    before and read just after (20 launches), and through the plain
    version: sum(y * y) within 1e-5 relative (summed in float64: in
    float32 the sum passes its largest value, about 2e41 here); the plan
    seconds, the ms a product of the loop (the best of 3, CUDA events),
    Gnnz/s and GB/s as the script counts them.

    Returns ({tag: K1/K2 inputs}, {tag: launches per operator}, K4
    inputs) for the kernel table."""
    import torch
    from pyamg_tpu_torch.ops import sell_kernels as sk
    from pyamg_tpu_torch.sparse import sell as sellm
    from pyamg_tpu_torch.sparse.matrix import DIA, to_scipy
    want = JAX_SCALE if want is None else want
    tag = f"{n}^2"
    t0 = time.perf_counter()
    A64, A32, ml, steps, (levels, oc) = setup.result()
    print(f"scale: {tag} host setup received from its process after "
          f"waiting {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for name, fn in (("collapse_coarse",
                      lambda: ml.collapse_coarse(max_n=4096, device=dev)),
                     ("enable_ds_refinement",
                      lambda: ml.enable_ds_refinement(A64, device=dev)),
                     ("to_device", lambda: ml.to_device(dev))):
        timed(steps, name, lambda: (fn(), torch.cuda.synchronize()))
    held = torch.cuda.memory_allocated() - base
    rows = [int(lvl.A.shape[0]) for lvl in ml.levels]
    grid = grid_rows(n)
    active = want["active"]
    lay = layout(ml)
    dia = {f"A{i}": len(lvl.A.offsets) for i, lvl in enumerate(ml.levels)
           if isinstance(lvl.A, DIA)}
    print(f"scale: {tag} setup and prep by step (s; to compress_stencils "
          f"in the setup's process) "
          f"{ {k: round(v, 3) for k, v in steps.items()} }, in all "
          f"{sum(steps.values()):.2f} s")
    print(f"scale: {tag} levels {levels} active {len(ml.levels)} (JAX "
          f"package {want['levels']} / {active}) rows {rows} "
          f"operator_complexity {oc!r} (JAX package "
          f"{want['operator_complexity']}) layout {lay} DIA diagonals {dia}; "
          f"the placed hierarchy holds {held} bytes of device memory")
    check(levels == want["levels"] == len(grid) and
          len(ml.levels) == active,
          f"{tag}: {levels} levels, {len(ml.levels)} active, not the JAX "
          f"package's {want['levels']} / {active}")
    check(rows == grid[:active], f"{tag}: rows {rows}, the grid rule "
                                 f"{grid[:active]}")
    check(round(oc, 4) == want["operator_complexity"],
          f"{tag}: operator complexity {oc} off the JAX package's "
          f"{want['operator_complexity']}")
    check(lay == [("DIA", "PhaseStencil", "PhaseStencil")] * (active - 1) +
          [("DIA", "NoneType", "NoneType")] and
          dia == {f"A{i}": 5 if i == 0 else 9 for i in range(active)},
          f"{tag}: layouts {lay} or DIA widths {dia} are not grid SA's")

    inputs = path_kernels(dev, {"name": tag, "ml": ml}, rng, sms,
                          phase="scale")
    b = np.random.default_rng(SEED).standard_normal(A64.shape[0])

    def solve(**extra):
        return ml.solve_refined_device(b, tol=1e-10, inner_tol=1e-5,
                                       inner_maxiter=40, max_outer=10,
                                       **extra)

    def near(it, w):
        return abs(it["outer"] - w["outer"]) <= 1 and \
            abs(it["inner"] - w["inner"]) <= 1

    path = {"name": tag, "ml": ml, "S": to_scipy(A64), "b": b, "kw": {},
            "solve": solve, "reads": 1, "iterations_ok": (near, "within 1"),
            "must": ("dia_spmv", "dia_gs_sweep")}
    _, per_op, _ = drive_path(path, want, reps, phase="scale")
    print(f"scale: {tag} peak device memory {torch.cuda.max_memory_allocated()}"
          f" bytes (at the phase's start {base} held), the placed "
          f"hierarchy {held}")
    del path, A64

    # (b) the SELL plan of the same float32 operator, K4 regime
    t0 = time.perf_counter()
    S = sellm.sell_from_ell(A32, k_choices=(4,))
    t_plan = time.perf_counter() - t0
    del A32
    check(S is not None and S.square and
          S.x_rows * sellm.LANE * 4 > sellm._VMEM_X_BUDGET,
          f"the {tag} plan is not a square SELL in the K4 regime")
    check(S.nnz == JAX_SELL_SCALE["nnz"] and
          S.n_passes == JAX_SELL_SCALE["passes"],
          f"the {tag} plan holds {S.nnz} entries in {S.n_passes} passes, not "
          f"the JAX package's {JAX_SELL_SCALE}")
    Sd = S.to(dev)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        S.shape[1]), device=dev).float()
    y, y_plain = sk.sell_spmv(Sd, x), sk.sell_spmv_plain(Sd, x)
    torch.cuda.synchronize()
    err, scale = rel_err(y, y_plain)

    def loop(mv):
        y = x
        for _ in range(20):
            y = mv(Sd, y) / 1.0001
        return y

    reset_kernel_launches()
    y_k = loop(sk.sell_spmv)
    torch.cuda.synchronize()
    launched = (sk.sell_spmv.launches, sk.sell_spmv.by_op[sk.plan_key(Sd)])
    y_p = loop(sk.sell_spmv_plain)
    s_k, s_p = (float(v.double().square().sum()) for v in (y_k, y_p))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(3):
        start.record()
        loop(sk.sell_spmv)
        stop.record()
        stop.synchronize()
        ts.append(start.elapsed_time(stop) / 1e3 / 20)
    t = min(ts)
    nbytes = Sd.vals.nbytes + Sd.delta.nbytes + 2 * S.shape[0] * 4
    print(f"scale: K4 {tag} plan (k_choices=(4,)) {t_plan:.2f} s: passes "
          f"{S.n_passes} K={S.K} Sy={S.Sy} nnz {S.nnz} (JAX package "
          f"{JAX_SELL_SCALE}), x {S.x_rows * sellm.LANE * 4 / 2**20:.1f} MiB "
          f"in the reference's layout (VMEM budget "
          f"{sellm._VMEM_X_BUDGET / 2**20:.0f} MiB), "
          f"{sk.spmv_geometry(S.n_passes, S.shape[0])}; one product "
          f"max_abs_err={err:.3e} tol={1e-6 * scale:.3e}")
    print(f"scale: K4 {tag} loop of 20 products y = S y / 1.0001: launches "
          f"{launched[0]} (of this plan {launched[1]}), sum(y*y) "
          f"{s_k!r} against the plain version's {s_p!r} (relative "
          f"{abs(s_k - s_p) / abs(s_p):.3e}, tol 1e-5; in float32 "
          f"{float(y_k.square().sum())}); {t * 1e3:.4f} ms a product (best "
          f"of 3, all {[round(v * 1e3, 4) for v in ts]}), "
          f"{S.nnz / t / 1e9:.3f} Gnnz/s, {nbytes / t / 1e9:.1f} GB/s "
          f"({nbytes} bytes a product, as the script counts them); peak "
          f"device memory {torch.cuda.max_memory_allocated()} bytes")
    check(err <= 1e-6 * scale, f"K3 in the K4 regime at {tag} disagrees "
                               f"with its plain version")
    check(launched == (20, 20), f"the 20-product loop launched K3/K4 "
                                f"{launched} times, not 20")
    check(np.isfinite(s_k) and abs(s_k - s_p) <= 1e-5 * abs(s_p),
          f"the 20-product loop's sum(y*y) {s_k} is not within 1e-5 of the "
          f"plain version's {s_p}")
    return {tag: inputs}, {tag: per_op}, (Sd, S, x, err, launched[0])


def scale_rows(dev, sms, rng, row, setup):
    """Run ``scale_phase`` on ``setup`` (a ``ScaleSetup``) and return its
    rows of the kernel table: K1 and K2 on the 3163^2 levels 0 and 1, K3
    in the K4 regime on its plan."""
    from pyamg_tpu_torch.sparse.sell import sell_to_scipy
    t0 = time.perf_counter()
    inputs, per_op, (Sd, S, x, err, launches) = scale_phase(dev, sms, rng,
                                                            setup)
    print(f"scale: phase before its times {time.perf_counter() - t0:.2f} s")
    tag = f"{SCALE_N}^2"
    ops = ((tag, "A0"), (tag, "A1"))
    rows = dia_rows(dev, sms, row, inputs, per_op, ops, ops)
    rows.append(sell_spmv_row(
        row, dev, f"sell_spmv (K4 regime, 2-D Poisson {tag}, k_choices=(4,),"
        f" the scale: loop of 20 products)",
        "pyamg_tpu/ops/sell_kernels.py:108", Sd, sell_to_scipy(S), x, err,
        f"sell_spmv K4 regime {tag}", launches))
    print(f"scale: phase with its times {time.perf_counter() - t0:.2f} s")
    return rows


def main(only=None):
    """Every phase; with ``only="scale"`` the device section and the
    ``scale:`` phase alone (``python3 chip_smoke.py scale``), with
    ``only="parallel2"`` the device section and the ``parallel2:`` phase
    alone (``python3 chip_smoke.py parallel2``), with ``only="bell"`` the
    device section and the ``bell:`` phase alone (``python3 chip_smoke.py
    bell``), with ``only="blocks"`` the device section and the phases
    whose paths run K7: ``sa_more:``, ``bell:`` and ``classical2:``
    (``python3 chip_smoke.py blocks``)."""
    t_start = time.perf_counter()
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import ds as dsm
    from pyamg_tpu_torch.ops import launch
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
    card, sms = device_section(dev)
    if only == "bell":
        # the bell: phase alone, with K7's rows of the kernel table
        flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
        row = functools.partial(kernel_row, flush, flush_ops(flush))
        rows = bell_phase(dev, row)
        print(f"chip_smoke: the bell: phase passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if only == "blocks":
        # every phase whose paths run K7: sa_more (elasticity 100^2), bell
        # and classical2 (block AIR), with K7's rows of the kernel table
        flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
        skip = flush_ops(flush)
        row = functools.partial(kernel_row, flush, skip)
        print(f"chip_smoke: sa_more starts at "
              f"{time.perf_counter() - t_start:.1f} s")
        sa_more_phase(dev, sms, rng, flush, skip)
        print(f"chip_smoke: bell starts at "
              f"{time.perf_counter() - t_start:.1f} s")
        rows = bell_phase(dev, row)
        print(f"chip_smoke: classical2 starts at "
              f"{time.perf_counter() - t_start:.1f} s")
        classical2_phase(dev)
        print(f"chip_smoke: the sa_more:, bell: and classical2: phases "
              f"passed in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if only == "parallel2":
        # the parallel2: phase alone, with K6's rows of the kernel table
        flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
        row = functools.partial(kernel_row, flush, flush_ops(flush))
        rows = parallel2_phase(dev, row=row)
        print(f"chip_smoke: the parallel2: phase passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    # the scale: phase's minutes of host setup, in a process of its own
    # beside the phases before it
    scale_setup = ScaleSetup()

    def mark(phase):
        print(f"chip_smoke: {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s")
    if only == "scale":
        # the scale: phase alone, with its rows of the kernel table
        flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
        row = functools.partial(kernel_row, flush, flush_ops(flush))
        rows = scale_rows(dev, sms, rng, row, scale_setup)
        print(f"chip_smoke: the scale: phase passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    mark("launch")
    # -- 1b. launch: device-stopped solves before any profiler session ---
    t0 = time.perf_counter()
    ml_l, b_l = launch_phase(dev)
    print(f"launch: phase {time.perf_counter() - t0:.2f} s")
    cupti_phase(ml_l, b_l)
    del ml_l, b_l

    mark("kernels")
    # -- 2. kernels against their plain versions ---------------------------
    _, ml_k, _ = build_hierarchy(500, 0, dev, ds=False)
    t0 = time.perf_counter()
    _, ml_s = build_sa3d(64)
    ml_s.to_device(dev)
    print(f"kernels: 64^3 setup+compress+place {time.perf_counter() - t0:.2f}"
          f" s")
    kernel_inputs = {}
    k1_capacity = dk.spmv_capacity(launch.library("dia_kernels",
                                                  dk.ENTRY_POINTS))

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

    # K2 recorded in a CUDA graph and replayed, eager launches between the
    # replays, in both launch regimes (staged; the band read each pass)
    for name in ("500^2 level 0", "64^3 A0"):
        k2_replay_gate(dev, name, *k2_ops[name])

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

    mark("main")
    # -- 3. main path --------------------------------------------------------
    reset_kernel_launches()
    t0 = time.perf_counter()
    A64, ml, (nlev_setup, oc) = build_hierarchy(500, 4096, dev)
    ml.to_device(dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    b = np.random.default_rng(SEED).standard_normal(A64.shape[0])
    it, res = {}, []
    reset_kernel_launches()
    t0 = time.perf_counter()
    x = ml.solve_refined_device(b, tol=1e-10, inner_tol=1e-5,
                                inner_maxiter=30, max_outer=10,
                                residuals=res, iterations_out=it)
    t_cold = time.perf_counter() - t0
    main_cold, main_counts = (x, res, it), counters()
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

    mark("sa3d")
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
    reset_kernel_launches()
    it3, res3 = {}, []
    t0 = time.perf_counter()
    x3 = ml3.solve_refined(b3, A_fine=S3, tol=1e-10, accel="cg",
                           residuals=res3, iterations_out=it3)
    t_cold3 = time.perf_counter() - t0
    sa3d_cold, sa3d_counts = (x3, res3, it3), counters()
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
    per_op3 = {k.__name__: {name: k.by_op[sk.plan_key(S)]
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

    mark("spgemm")
    # -- 4b. spgemm: the device form of SpGEMM at full size ---------------
    t0 = time.perf_counter()
    spgemm_phase(dev, card)
    print(f"spgemm: phase {time.perf_counter() - t0:.2f} s")

    mark("times")
    # -- 5. times -------------------------------------------------------------
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ml.solve_refined_device(b)
        walls.append(time.perf_counter() - t0)
    print_profile("500^2 captured per step",
                  *profiled(per_step(lambda: ml.solve_refined_device(b))))

    def main_run():
        r, i = [], {}
        return ml.solve_refined_device(b, residuals=r, iterations_out=i), r, i

    main_median = statistics.median(walls)
    t_cycle = forms_gate("times", "500^2", main_run, 1, ml, 5,
                         (main_cold, main_counts), "V",
                         op_profile=True)["cycle_s"]
    per_iteration = main_median / main_cold[2]["inner"]
    check(0 < t_cycle < per_iteration,
          f"500^2: profile_cycle {t_cycle:.3e} s is not positive and below "
          f"the captured solve's {per_iteration:.3e} s an iteration")
    trace_dir = ml.trace_cycle(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "pyamg_tpu_torch",
        "_build", "cycle_trace"))
    with open(os.path.join(trace_dir, "cycle_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k2_events = [k for k in kernels if "dia_gs_" in k]
    print(f"capture: trace_cycle wrote {trace_dir}/cycle_trace.json: "
          f"{len(events)} events, {len(kernels)} kernels, {len(k2_events)} "
          f"of K2 ({sorted(set(k[:60] for k in k2_events))})")
    check(k2_events, "trace_cycle's trace holds no K2 (dia_gs_sweep) kernel")

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
    print_profile("64^3 captured per step", *profiled(per_step(
        lambda: ml3.solve_refined(b3, A_fine=S3, tol=1e-10, accel="cg"))),
        top=16)

    def sa3d_run():
        r, i = [], {}
        return ml3.solve_refined(b3, A_fine=S3, tol=1e-10, accel="cg",
                                 residuals=r, iterations_out=i), r, i

    forms_gate("times", "64^3", sa3d_run, lambda it: len(it["inner"]), ml3,
               5, (sa3d_cold, sa3d_counts), "V", op_profile=True)

    sell_src = SELL_SRC
    sell_row = functools.partial(sell_spmv_row, row, dev)

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

    mark("solvers")
    # -- 6. solvers: the rest of the solve phase -----------------------------
    t0 = time.perf_counter()
    paths = solver_paths(dev)
    print(f"solvers: setup+compress+place of the six paths "
          f"{time.perf_counter() - t0:.2f} s")
    solver_launches = solvers_phase(dev, paths, JAX_SOLVERS,
                                    JAX_S1_TRUE_RELRES)
    print(f"solvers: launches per solve {solver_launches}")

    mark("krylov")
    # -- 6b. krylov: every Krylov method of solve, device-stopped ----------
    t0 = time.perf_counter()
    krylov_phase(dev, paths[0][8][0], paths[0][3],
                 torch.as_tensor(paths[0][4], device=dev))
    print(f"krylov: phase {time.perf_counter() - t0:.2f} s")
    del paths

    mark("classical")
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

    mark("sa_more")
    # -- 8. sa_more: anisotropic diffusion 512^2 and elasticity 100^2 -------
    t0 = time.perf_counter()
    sinputs, sper_op = sa_more_phase(dev, sms, rng, flush, skip)
    print(f"sa_more: phase before its times {time.perf_counter() - t0:.2f} s")
    # K1 and K2 on the anisotropic finest level and on A3 (361 rows, the
    # small-level regime)
    aniso = (("anisotropic", "A0"), ("anisotropic", "A3"))
    rows += dia_rows(dev, sms, row, sinputs, sper_op, aniso, aniso)
    del sinputs

    mark("bell")
    # -- 8b. bell: K7 at the elasticity cell's shapes ----------------------
    rows += bell_phase(dev, row)

    mark("families")
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

    mark("blackbox")
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

    mark("classical2")
    # -- 10b. classical2: block AIR and complex RS/AIR ---------------------
    t0 = time.perf_counter()
    classical2_phase(dev)
    print(f"classical2: phase {time.perf_counter() - t0:.2f} s")

    mark("parallel")
    # -- 11. parallel: the row-sharded solve on a one-rank NCCL group ------
    t0 = time.perf_counter()
    parallel_phase(dev)
    print(f"parallel: phase {time.perf_counter() - t0:.2f} s")

    mark("parallel2")
    # -- 12. parallel2: the distributed setup and its solves ---------------
    t0 = time.perf_counter()
    rows += parallel2_phase(dev, row=row)
    print(f"parallel2: phase {time.perf_counter() - t0:.2f} s")

    mark("scale")
    # -- 13. scale: the JAX package's 10M-unknown single-chip configurations
    rows += scale_rows(dev, sms, rng, row, scale_setup)

    mark("the JSON lines")
    print(f"chip_smoke: every check passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import sys
    check(sys.argv[1:] in ([], ["scale"], ["parallel2"], ["bell"],
                          ["blocks"]),
          f"usage: {sys.argv[0]} [scale|parallel2|bell|blocks] (got "
          f"{sys.argv[1:]})")
    main(*sys.argv[1:])
