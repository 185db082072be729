"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --bench LABEL
    python3 chip_smoke.py --phases
    python3 chip_smoke.py --breadth
    python3 chip_smoke.py --parfor
    python3 chip_smoke.py --dnn
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --profile
    python3 chip_smoke.py --fleet
    python3 chip_smoke.py --shapes

The second form times only the spoof kernels K2, K3 and K5, the spoof
wrappers' host time, K6 and LinearRegCG-cla (see `bench`); copied into a
checkout of an earlier tree it runs there too, so two trees compare
within one chip call. The third shows where K6's time goes (see
`phases`). The fourth runs only the algorithm-breadth paths and the
datagen check (phase 3's `[breadth]` and `[datagen]` lines), the fifth
only the parfor and transform phases (`[parfor-stepglm]`,
`[parfor-univar]`, `[transform]`) under the sync audit (`[syncs]`).

Drives the port's paths through systemml_tpu_torch.api.mlcontext.MLContext
on the card, on one X of 2,000,000 x 1,000 fp32 (scripts/perftest scale
L) made on the card from a seeded generator, and holds every kernel of
those paths against its plain PyTorch version. Every path runs its loops
as fused regions (runtime/loopfuse.py; codegen_enabled at its default):
each loop nest one CUDA graph with its predicates on the card
(conditional WHILE and IF nodes, csrc/loop_graph.cu), launched once per
loop entry, or refused for a classified reason and run eagerly:

- LinearRegCG at optlevel 2 (kernel K1, mmchain) and at optlevel 3;
- l2-svm (maxiter 15, labels +-1 from sign(X w + 0.1 noise)) and
  MultiLogReg (moi 10, 5 classes from the quintiles of X w + noise) at
  optlevel 3, where the spoof fusion pass runs their fused plans through
  kernels K2 (the cell template) and K4 (the row template), and at
  optlevel 2 beside them;
- LinearRegCG-cla: LinearRegCG with cla "auto" on a categorical X of
  2,458,285 x 68 fp32 (the Census shape of the CLA evaluation, Elgohary
  et al., VLDB 2016; synthetic: column j takes d_j values, d_j in 2..8,
  uniform codes, dictionary values drawn N(0, 1) and standardised per
  column), which compresses X at loop entry and runs each CG iteration's
  compressed mmchain through kernel K6; beside it the same script with
  cla "false", and l2-svm on the same X with both;
- ALS-CG-ml10m: scripts/algorithms/ALS-CG.dml (rank 10, reg 0.01, maxi
  5, mii 3, the arguments of scripts/perftest/run_perftest.py:216-218) on
  a dense fp32 ratings matrix of the MovieLens 10M shape (GroupLens
  ml-10M100K: 71,567 users x 10,681 movies, 10,000,054 ratings, 1.308%
  dense; synthetic: a Bernoulli pattern at that density, each rating a
  rank-10 product plus noise rounded to half stars in 0.5..5.0), at
  optlevel 3, where its loss check runs the outer-product template
  through kernel K5 and its CG reductions through K2, and at optlevel 2
  (the dense wdivmm arm); then a user's ratings summary (sum, min and max
  of the mean-centred observed ratings) on the same V, which runs the
  multi-aggregate template through kernel K3;
- the algorithm-breadth paths on the same X, with the arguments of
  scripts/perftest/run_perftest.py: LinearRegDS (reg 1e-3, y = X
  beta_true: tsmm and solve once, K2), GLM-poisson (y ~ Poisson(2)
  i.i.d.; dfam 1, vpow 1, link 1, lpow 0, moi 10, tol 1e-8, reg 1e-3)
  and GLM-probit (y ~ Bernoulli(pnorm(X w / sqrt(1000))); dfam 2, link
  3), each IRLS while loop a region (K2), and Kmeans (k 5, maxi 10, runs
  1, samp 50: the k-means++ init runs seq, rexpand, cumsum and seeded
  rand, its for loop refused for C's growing shape; the Lloyd while loop
  a region with rowIndexMax, rowMins and rexpand, K4 and K2);
- minibatch-sgd: the training body of scripts/nn/examples/
  mnist_softmax.dml inlined (MINIBATCH_SGD: batches X[beg:end,] with end
  = beg + bs - 1, a dropout mask drawn with seed 7 + i, 5 one-hot
  classes, bs 1,000, one epoch of 2,000 iterations), its for loop one
  graph whose slices start at a device offset and whose seed is a
  device value; its one fused plan at optlevel 3 a row plan (K4).

Phases:

0. environment: torch and CUDA versions (the runtime and driver that
   conditional graph nodes need: 12.4 or later), the card, its power
   limit;
1. build: the paths' programs are compiled at optlevel 3, each building
   its fused plans (one generated source per plan, csrc/spoof.cuh) as
   compile_program does on the card, while csrc/mmchain.cu and
   csrc/cla_chain.cu build beside them; then the kernel phase's other
   plans, one source per plan and Variant (its aggregates, scalar and
   aliased leaves: every order of AGG_ORDERS is a source); one nvcc per
   source, a program's together; nvcc seconds and ptxas report per source
   and kernel (registers, spills); ALS-CG and the ratings summary build
   theirs (K5's outer plan, K3's multi-aggregate plan, ALS-CG's cell
   plans);
2. each kernel against its plain version: mmchain at the main path's
   shapes and others (normwise relative error against the plain version
   in fp64 on the card, bar 1e-4: fp32 sums over up to 2e6 rows in
   another order); the spoof cell (elementwise and sum) and row (sum, min,
   max) kernels in fp32 and fp64 on l2-svm's 10-leaf plan at
   (2,000,000, 1), MultiLogReg's row plan at (2,000,000, 5), a ragged
   (100,003, 7) plan with (1, n), (m, 1), (1, 1), host-number and 0-d
   leaves, and a plan of every cell op with NaN into min and max, 0 into
   sign and x.5 into round (bars: 1e-5 normwise in fp32 against the
   plain version in fp64, 1e-12 in fp64, NaN at the same places); K6
   against chain_plain in fp64 on the card at the Census shape (68
   groups of up to 8 codes over 2,458,285 rows) and at a ragged
   (100,003, 7) block, every chain type, k = 1 and 4, fp32 and fp64
   (bars 1e-5 and 1e-12 normwise), at the Census shape in fp32 with NaN,
   +Inf and -Inf rows in w and y (NaN and +-Inf in the plain version's
   slots) and with every row of each group on one code, and two blocks
   that K6 refuses by layout (a dictionary of 9, an uncompressed column)
   taking the gather arm, counted, with no launch; K5 against outer_plain
   in fp64 on the
   card at ALS-CG-ml10m's shape (X its 0/1 pattern, rank 10, its loss
   plan) and at a ragged (100,003, 777, r = 3) X, fp32 and fp64 (bars
   1e-5 and 1e-12), with a plan of a host-number and a 0-d scalar leaf,
   and NaN in X; K3 against multiagg_plain likewise, on the ratings
   summary's plan over V and on the ragged and NaN plans above, every
   aggregate order of AGG_ORDERS (one of 10 aggregates); the port's rand() on the card against its rand() on
   the CPU, bit for bit, in fp32 and fp64. Every kernel runs twice: the
   two results must be bit-identical. set_cond, the loop-control kernel
   of csrc/loop_graph.cu, against its plain version: IF nodes and their
   negation on predicates of five dtypes with 0, 1, -2.5 and NaN, each
   flag against pred != 0 on the host;
2b. the region bridge on small scripts (BRIDGE: a zero-trip while, a
   while nested in a while, an if/else in a while, a for in a while, an
   inner loop that runs no iteration in some outer passes), fp64 through
   MLContext on the card and on the CPU (the region executor's plain
   arm), equal within 1e-12; and REENTRY compiled once and run with maxi
   5, 9 and 5: one capture, three graph launches, bit-identical results;
3. the paths, each with every launch counter set to 0 just before it and
   read just after, each followed by a `regions` line (the regions
   planned, captured and refused with their reasons, the graph launches
   and host syncs per loop entry, the trips, the kernel launches per body;
   it fails on a refusal other than Kmeans's init's "shape change", and
   on a region that is not one launch per entry and per print-ring drain,
   a sync per launch and one per while entry; those syncs are also
   counted by torch under sync debug mode "warn", in each region's
   launches, drains and exit and in each entry that met its cache, and
   a `[syncs]` line fails on any difference from the record); LinearRegCG
   at optlevel 2,
   MultiLogReg at 3, l2-svm at 3 and 2 (its 15 printed lines equal the
   eager run's, in order, one per outer iteration of its one region),
   minibatch-sgd at 3, LinearRegCG-cla, and ALS-CG-ml10m at 3, also with
   codegen_enabled False: the region's
   output bit-identical to the eager run's or within 1e-5 normwise, equal
   launch counts of every kernel, ms per iteration in the graph and the
   eager loop's, the busy share (the eager run's kernel time per loop
   period over the graph's ms per iteration), peak memory allocated and
   reserved; LinearRegCG at optlevel 2 (mmchain once per CG
   iteration, beta within 1e-3 of beta_true, peak allocated below twice
   X's bytes; timed without a profiler, a second unprofiled run, two
   runs under torch.profiler and one under cProfile), then LinearRegCG at
   optlevel 3, l2-svm and MultiLogReg at optlevels 3 and 2: the
   templates selected, the kernel launches (at optlevel 3 the cell
   kernel, and for MultiLogReg the row kernel, must launch; no plan may
   take the plain arm by layout and no block may fail to compile; every
   cell and multi-aggregate launch is counted on the flat or the general
   walk, and printed), the
   seconds per outer iteration without a profiler, the difference from
   the optlevel-2 run (bar 1e-3 normwise) and the peak memory; then
   LinearRegCG-cla at optlevel 2 with cla "auto" (X compressed once, K6
   once per CG iteration, cla_chain_plain_by_layout 0, beta within 1e-3
   of the cla "false" run's and of beta_true; its CG loop one graph, run
   again bit for bit and without regions) and "false", and l2-svm on
   the same X with both (w within 1e-3); the loop-entry compression
   (sample, host copy, compress()) is timed apart from the loops;
   ALS-CG-ml10m at optlevels 3 and 2 (at 3: the templates selected, K5
   once per outer iteration, K2 launching, no compile error, the plain
   arm by layout only for the two regularizer plans that the JAX
   package's kernel refuses too; L and R within 1e-3 normwise and the
   loss within 1e-3 of optlevel 2; ms per outer iteration without a
   profiler and the peak allocated memory), then the ratings summary at
   optlevels 3 (K3 once) and 2 (s, lo and hi within 1e-5 relative; s, a
   cancellation near 0, within 1e-6 x sum|Z|); the algorithm-breadth
   paths, each at optlevel 3 with regions and without, and at optlevel
   2 (a `[breadth]` line each: ms per outer iteration in the graph,
   eagerly and at optlevel 2, for LinearRegDS ms for the whole
   execution; K2 and K4 launches with regions and without, which must be
   equal; graph launches and host syncs per loop entry; refusals; peak
   allocated over the data; with regions against without bit-identical
   or within 1e-5 normwise, optlevel 3 within 1e-3 of optlevel 2):
   LinearRegDS's beta within 1e-3 of beta_true, GLM's deviance over its
   IRLS log (the eager run's) non-increasing within 1e-6 relative,
   Kmeans's WCSS non-increasing over its Lloyd iterations (the script's
   first, the rest replayed in fp64 from its first update, a run with
   maxi 1) and its last WCSS within 1e-5 of the replay's (its C_out
   beside the replay's, printed);
   then `[datagen]`: sample(2000000, 5, 7), sample(3000000, 10, TRUE, 7),
   a full permutation of 3,000,000 and seq(1, 2000000, 8000) on the
   card equal to the CPU's draw bit for bit, in fp32 and fp64; then
   `[minibatch]`: minibatch-sgd at optlevel 3 with regions and without
   and at 2 (ms per iteration, launches, host syncs; W with regions
   within 1e-5 of the eager run's or equal; every batch's mask equal to
   the CPU's draw bit for bit), the loop without its dropout
   draw, and one draw alone replayed as a graph;
4. times: each kernel and its plain version at the paths' shapes (CUDA
   events over back-to-back calls; for the spoof kernels, whose calls are
   shorter on the card than on the host, also the device time per call
   from torch.profiler, which K2's and K4's records give with the L2
   cache evicted before each call), the library call that computes the same
   function where there is one, and the least time the card could take
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s fp32, the H100
   SXM's published peaks); K2 also on the cell sum that ALS-CG-ml10m
   launched most, at its own inputs, and on the elementwise arm of the
   summary's plan over V, an (m, n > 1) plan; and the host time of one
   spoof wrapper call (row, cell sum, multi-aggregate);
   the compressed left mult t(X) %*% y at the Census-shaped block, its
   fixed-order segment sums against the bincount they replaced, and one
   group of 65,536 codes, 60% of the rows on one code (`[cla-left]`:
   times, layout bytes, build ms, agreement, repeats bit-identical);
   K6 at the path's own compressed X (CUDA events over back-to-back
   calls, as K1, K3 and K5; beside them the device time per call from
   torch.profiler and the wrapper's host time), on the same
   shape with every row on one code, its plain version, the whole
   compressed chain around it, the gather arm, and as its yardstick the
   two-pass torch.matmul on the dense X (no single torch call computes
   a compressed chain); K5 and K3 at ALS-CG-ml10m's shape against their
   plain versions and bounds, with yardsticks (no single torch call
   computes either): torch.matmul(U, V.T), the unfused route's first
   step, for K5, and the unfused sequence (the plain version) for K3.

Beside phase 3, the slice of the CLI, io/, the buffer pool and the
whole-block compile (each a line of its own, each failing the run on a
failed check):

- `[cli]`, right after the main path: X written by the port's writer as
  a binary block (8.0 GB) and y as csv, each with its .mtd, into a fresh
  temporary directory (the free disk bytes printed first), X read back
  (native arm, pinned memory, one copy to the card) and held to what was
  written; then LinearRegCG.dml run by `python -m systemml_tpu_torch
  -stats` over those files as a subprocess, B read back within 1e-3 of
  beta_true and 1e-5 of the MLContext run, K1 as many launches as that
  run, both reads on the native arm; write and read GB/s, parse and
  compile seconds, ms per CG iteration, the heavy hitters;
- `[pool]`, after the sparse paths: POOL_SCRIPT (three derived copies of
  X in blocks of their own, each reduced later in a block of its own,
  and a loop reading one of them after its eviction) under an 11 GB
  pool budget, against the pool off: results bit-identical, evictions
  and restores above 0, the peak without the pool (A, B and C live) at
  least twice the budget, the peak with it within the budget plus the
  largest block's working set (measured: one block's peak without the
  pool), which the run without the pool must exceed;
- `[block]`: Kmeans's optlevel-3 run of the breadth phase through the
  whole-block compile: its peak over the data below 2.5 GB (`rowSums(X ^
  2)` a K4 row plan, `X ^ 2` not formed), the blocks planned, the eager
  blocks by reason, K2 and K4, and their totals over the paths;
- `[jmlc]`: `yhat = X %*% B` and a softmax scorer, each prepared once
  with graphs on and once off and called 200 times on 1,000-row batches
  of X: the scorer's calls through the plan until one is free of
  synchronizing calls, the next captured as a CUDA graph, the rest
  launches; the product refused a graph as one op; each result against
  the same call without graphs; ms per call of both;
- `[serving]`, after `[jmlc]`: the softmax scorer over X's 1,000
  features and 10 classes (W 1,000 x 10 and b 1 x 10 fp32 from a seeded
  generator) prepared at optlevel 3, where it is one row plan (K4), and
  served through api/serving.ScoringService with validate "force" on the
  ladder 1/8/64/512: warmup(1000) (a capture per rung), then 16 client
  threads sending 2,000 requests of log-uniform 1-512 rows taken from a
  host copy of X's first 100,000 rows (two, of 700 and 900 rows, open
  rung 1,024 mid-traffic: one miss, one plan compile, one capture), then
  64 client threads of 50 single-row requests each through a
  MicroBatcher (max_batch 64, deadline 2,000 us), with /metrics served on
  loopback. It fails unless: "auto" is refused at optlevel 3 with the
  JAX package's reason and proven at optlevel 2; every answer is within
  1e-5 normwise of torch's softmax on the card and within 1e-6 of the
  same rows at their exact shape with validate "off" and codegen off;
  after warmup nothing compiles, captures or builds but rung 1,024's
  plan and capture; K4's launches equal the optlevel-3 dispatches; the
  srv_* counters equal the registry's; the scraped requests_total equals
  the requests served. It prints per-request p50 and p99 ms, requests/s
  and rows/s, the block graphs' captures and launches, the pad share,
  the flushes by cause and requests per flush, and K4 against its plain
  version at the scorer's plan at (512, 10). `--serving` runs it alone.
- `[fleet]`, after `[serving]`: the same scorer in three replica
  processes (`chip_smoke.py --fleet-replica RANK DIR`, fresh
  interpreters, a CUDA context each), each with its fleet identity, its
  trace shard and a Replica (fleet/replica.py) that serves generation 0
  only once warm; this process routes 16 client threads of log-uniform
  1-64-row requests (JSON, `{"x": rows}`) through a Router over
  http_transport. The last replica SIGKILLs itself after 150 answers;
  then a rolling update to generation 1 (its own W and b) runs under the
  same load, and an overload run follows: each survivor admits 2
  requests at a time while requests arrive open-loop at twice the first
  run's rate for 4 s, with a 2 s deadline each. It fails unless every
  answer is within 1e-5 of torch's softmax with its generation's weights
  and more than 1e-3 from the other's, no request failed in the first
  run and the rollout, the kill was one route-epoch bump, each
  survivor's K4 launches equal its dispatches with nothing compiled or
  captured after either warmup, the merged shards tell the rollout and
  the epoch bump, every overload request was served in time or shed
  with a named 429 reason within the retry budget, and `python -m
  systemml_tpu_torch.obs.fleet_trace` prints both storylines. It prints
  p50, p99 and requests/s through the router beside `[serving]`'s,
  redispatches, hedges, the kill's first redispatched answer, the
  rollout's seconds, the JSON share of a request and each replica's
  wait for the block compile's locks. `--fleet` runs it alone.

After the sparse paths, on LinearRegCG-cla's Census-shaped X and still
under the `[syncs]` audit (per thread, so each parfor lane's region
entries are held to its own calls), the slice of parfor, frames and
transform (each failing the run on a failed check):

- `[parfor-stepglm]`: scripts/algorithms/StepGLM.dml with its defaults
  (logit, tol 1e-8, moi 25, thr 0.01), y ~ Bernoulli(sigmoid(X[:, P] w))
  from a seeded generator on the card, P four planted columns
  (STEPGLM_PLANTED), |w| = 1.97; at optlevel 3 with regions and at
  optlevel 2, each with its parfor at the default par (on one card, one
  worker), with par=8 (eight lanes), with par=1 and replaced by a for
  loop; the default and par=8 runs at optlevel 3 run their second
  pass's parfor under torch.profiler. The selected set equal across the runs of an
  optlevel, the planted columns its first four, B within 1e-5 normwise
  of the for run's; seconds per stepwise pass (each parfor's window),
  the plan, region captures and graph launches per worker lane, kernel
  launches, peak memory over the data, and the device's busy share over
  the parfors (the union of the kernels' intervals inside them);
- `[parfor-univar]`: Univar-Stats.dml with K all 2 over the Census codes
  (1..d_j as fp32), a parfor over the 68 columns, each a table(col, 1):
  rows 15-17 equal numpy's bincount of the host copy, row 15 the drawn
  dims, the 17 x 68 matrix, at the default par and at par=8,
  bit-identical to the script with a for loop; ms of the three;
- `[transform]`: transform.dml, then apply-transform.dml, by the CLI
  (api/cli.main, in this process, on the card) over a csv frame with a
  header: the Census codes' first 200,000 rows as tokens (a frame is
  host strings), all 68 columns recoded and 4 dummycoded; the same two
  scripts on the CPU by `python -m systemml_tpu_torch` beside them.
  Apply's X equals encode's bit for bit, both equal the CPU's, encode's
  X was on the card; host seconds of the frame read, the encode and the
  apply.

The kernel phase also holds K2's functor for a product by a mask of the
same block (`[mask]`: op_mask_mul on `X * (X > 0)` over NaN, +-Inf and
negative cells, fp32 and fp64): +0 without a sign bit at every masked
cell, equal to its plain arm. After the kernels' times, `[profile]` (the
profiler, obs/profile.py; `--profile` runs it alone with K1's time and
`[mask]`): LinearRegCG on the dense X at optlevel 2 under profile_mode
"full" with regions (tol 0: 40 CG iterations; and with the path's own
arguments, 6) and as the eager configuration (codegen_enabled False), and
l2-svm at optlevel 3 (K2's rows): the bucket seconds and the named
coverage (failing below 0.95 on the first run), the region rows against
dispatch_stats and -stats' counters, each kernel row's ms a launch and
roofline_frac (the eager run's K1 rows counting every K1 launch, within
10% of K1's CUDA-event time), ingest_profile's rows; "off" with a
recorder against no recorder (launches, each region's entries, launches
and host syncs) and "sample" against "off" (dispatch counts); the CLI's
`-profile -trace out.json` and `out.jsonl` on 200,000 rows of X as
files; PreparedScript.set_trace on the softmax scorer.

`--shapes` (and the full run, after `[lenet]`) drives K1, K5 and K6 at
shapes past their former bounds, each path at full width on seeded data
made on the card: `[k1-wide]` LinearRegCG (optlevel 2, with regions and
without) on a 1,281,167 x 4,096 fp32 X (ImageNet-1k's training images x
VGG-16's fc7 width, a linear probe; 20.99 GB), K1 (its cluster kernel)
once per CG iteration, no kb_fallback, beta within 1e-3 of beta_true;
`[k5-rank100]` ALS-CG at rank 100 on the MovieLens-10M-shaped V,
optlevel 3 (K5, its rank slabs, once per outer iteration; no outer plan
by the plain arm) against optlevel 2, the losses within 1e-3;
`[k6-groups]` LinearRegCG with cla "true" on a categorical X of
2,458,285 rows and 408 columns of 2..8 values (six times the Census
columns: at k = 1 more groups than one block of K6 holds, 376 in fp32),
passed as one DDC group per column, against cla "false" on the dense X,
K6 (its group slabs) once per CG iteration, no
cla_chain_plain_by_layout, the betas within 1e-3. Each kernel is held
against its plain version in fp64 at its path's shape and timed beside
its bound, its plain version and a library call or yardstick; the
kernels line adds these paths' launches to K1's, K5's and K6's.

The kernels line also has set_cond: its ms the control of a WHILE loop
per iteration inside one graph, its plain_ms the same loop driven from
the host. Prints a {"kernels": [...]} line before the last, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero; without a CUDA
card, or without the repository around it, it exits non-zero before any
result.
"""

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
M, K = 2_000_000, 1_000        # scripts/perftest/run_perftest.py scale L
KERNEL_BAR = 1e-4
SPOOF_BARS = {torch.float32: 1e-5, torch.float64: 1e-12}
# systemml_tpu_torch/codegen/csrc/<name>.cu
KERNEL_SOURCES = ("mmchain", "cla_chain", "loop_graph")
# the Census data of the CLA evaluation (UCI US Census 1990): rows, columns
CENSUS_N, CENSUS_M = 2_458_285, 68
CHAIN_BARS = {torch.float32: 1e-5, torch.float64: 1e-12}
# MovieLens 10M (GroupLens ml-10M100K): users, movies, ratings
ML10M_USERS, ML10M_MOVIES, ML10M_RATINGS = 71_567, 10_681, 10_000_054
# scripts/perftest/run_perftest.py:216-218
ALS_ARGS = {"rank": 10, "reg": 0.01, "maxi": 5, "mii": 3}
# a user's summary of mean-centred observed ratings: one multi-aggregate
# plan at optlevel 3
SUMMARY = ("mu = sum(V) / sum(V != 0)\nZ = (V != 0) * (V - mu)\n"
           "s = sum(Z)\nlo = min(Z)\nhi = max(Z)\n")
# the multi-aggregate's orders: repeats, and more than 8 aggregates (any
# number compiles in)
AGG_ORDERS = (("sum", "min", "max"), ("max", "sum"), ("min",),
              ("min", "min", "sum", "max", "sum", "max", "min", "sum"),
              ("max", "sum", "min") * 3 + ("sum",))
ROOT = os.path.dirname(os.path.abspath(__file__))
ALG = os.path.join(ROOT, "scripts", "algorithms")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def normwise(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm(got.double() - ref) / torch.linalg.norm(ref))


def time_ms(fns, reps: int = 20, warm: int = 3):
    """ms per call of each fn, by CUDA events over `reps` calls after
    `warm` calls, taken in turns (a, b, ..., b, a) and averaged."""
    for fn in fns:
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    acc = [0.0] * len(fns)
    for order in (range(len(fns)), reversed(range(len(fns)))):
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[i]()
            end.record()
            end.synchronize()
            acc[i] += start.elapsed_time(end) / reps / 2
    return acc


class PhaseTimer:
    """Windows of the program's execution, of its while loops, and of the
    set-up inside a loop: a compressed X's loop-entry compression and the
    first builds of its device forms (K6's layout, the mirror of the other
    compressed ops), and a sparse invariant's device views at a region's
    entry, on the host clock and in CUDA events, taken without
    a profiler: for the duration of a with-block it wraps Program.execute,
    WhileBlock.execute and _maybe_auto_compress of the port's runtime,
    chain_layout and device_mirror of compress/device.py (those two are
    cached: only a first call builds) and FusedLoop._views. `windows[label]` lists (host ms,
    device ms, host start, host end, start event, end event) in the order
    the windows close; `compressed` the compressed blocks the compression
    bound."""

    SETUP = ("compress", "layout", "mirror", "views")

    def __init__(self):
        from systemml_tpu_torch.compress import device as cla_dev
        from systemml_tpu_torch.runtime import loopfuse, program
        self._targets = {"execute": (program.Program, "execute"),
                         "loop": (program.WhileBlock, "execute"),
                         "for": (program.ForBlock, "execute"),
                         "compress": (program, "_maybe_auto_compress"),
                         "layout": (cla_dev, "chain_layout"),
                         "mirror": (cla_dev, "device_mirror"),
                         "views": (loopfuse.FusedLoop, "_views"),
                         "capture": (loopfuse.FusedLoop, "_capture"),
                         "launch": (loopfuse.FusedLoop, "_launch")}
        self.windows = {label: [] for label in self._targets}
        self.compressed = []
        self.program = None

    def __enter__(self):
        self._orig = {label: getattr(owner, attr)
                      for label, (owner, attr) in self._targets.items()}
        for label, (owner, attr) in self._targets.items():
            setattr(owner, attr, self._wrap(label, self._orig[label]))
        return self

    def __exit__(self, *exc):
        for label, (owner, attr) in self._targets.items():
            setattr(owner, attr, self._orig[label])
        torch.cuda.synchronize()
        self.windows = {label: [(1e3 * (t1 - t0), e0.elapsed_time(e1), t0,
                                 t1, e0, e1) for t0, t1, e0, e1 in ws]
                        for label, ws in self.windows.items()}

    def _wrap(self, label, orig):
        from systemml_tpu_torch.compress import is_compressed

        def execute(blk, *args, **kwargs):
            if label == "execute":
                self.program = blk
            if torch.cuda.is_current_stream_capturing():
                # a loop nested in a region being captured: no event may
                # enter a conditional node's body
                return orig(blk, *args, **kwargs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            try:
                return orig(blk, *args, **kwargs)
            finally:
                t1 = time.perf_counter()
                e1.record()
                self.windows[label].append((t0, t1, e0, e1))
                if label == "compress":
                    self.compressed += [
                        v for v in args[0].vars.values()
                        if is_compressed(v) and all(
                            v is not c for c in self.compressed)]
        return execute


def profile_main_path(ml, script, host_activity: bool,
                      kernel: str = "mmchain_partial", loop: str = "CG loop"):
    """One more run of the main path under torch.profiler, recording the
    device's activity, and the host's too when `host_activity`. Returns
    (and prints) the device's busy share of the run's wall time (parse and
    compile included), the CG loop's period (median time from one launch
    of `kernel`, the loop body's, to the next) and the busy share inside
    the loop, and device ms by kernel name. Says "not measured" when the
    profiler records no kernels."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    printer, ml.printer = ml.printer, (lambda s: None)
    what = "host and device" if host_activity else "device only"
    activities = [ProfilerActivity.CUDA]
    if host_activity:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        ml.execute(script)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ml.printer = printer
    ks = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if not ks:
        print(f"[profile {what}] the profiler recorded no kernels: device "
              f"busy share not measured")
        return {}
    by_name = {}
    for e in ks:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms}
    starts = [e.time_range.start for e in ks if kernel in e.name]
    if len(starts) >= 2:
        in_loop = sum(e.time_range.elapsed_us() for e in ks
                      if starts[0] <= e.time_range.start < starts[-1])
        out["cg_iteration_ms"] = statistics.median(
            (b - a) / 1e3 for a, b in zip(starts, starts[1:]))
        out["cg_loop_busy_share"] = in_loop / (starts[-1] - starts[0])
    print(f"[profile {what}] main path under torch.profiler: wall {wall_ms:.1f} ms "
          f"(parse and compile included), kernels {device_ms:.1f} ms, device "
          f"busy {100 * out['device_busy_share']:.1f}%")
    if "cg_iteration_ms" in out:
        print(f"[profile {what}] {loop}: {out['cg_iteration_ms']:.3f} ms per "
              f"iteration ({kernel} launch to launch), device busy "
              f"{100 * out['cg_loop_busy_share']:.1f}% inside the loop")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, n) in top:
        print(f"[profile {what}]   {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    out["top_kernels_ms"] = {name[:90]: ms for name, (ms, _) in top}
    if host_activity:
        ops = sorted(prof.key_averages(),
                     key=lambda e: -e.self_cpu_time_total)[:8]
        for e in ops:
            print(f"[profile {what}]   host {e.self_cpu_time_total / 1e3:8.3f}"
                  f" ms own  x{e.count:<4d} {e.key[:80]}")
        out["top_host_ops_ms"] = {e.key[:80]: e.self_cpu_time_total / 1e3
                                  for e in ops}
    return out


def host_profile(ml, script) -> dict:
    """One more run of the main path with cProfile on during the program's
    execution (parse and compile left out): the Python functions that take
    the host's time, by their own time. Prints and returns the top 12."""
    import cProfile
    import pstats

    from systemml_tpu_torch.runtime import program

    prof = cProfile.Profile()
    orig = program.Program.execute

    def execute(*args, **kwargs):
        prof.enable()
        try:
            return orig(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            prof.disable()

    printer, ml.printer = ml.printer, (lambda s: None)
    program.Program.execute = execute
    try:
        ml.execute(script)
    finally:
        program.Program.execute = orig
        ml.printer = printer
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:12]
    out = {}
    for (path, line, fn), (_, calls, own, cum, _) in rows:
        where = (os.path.relpath(path, ROOT) if path.startswith(ROOT)
                 else os.path.basename(path))
        name = f"{where}:{line} {fn}"
        print(f"[cprofile] {1e3 * own:8.3f} ms own {1e3 * cum:8.3f} ms "
              f"cumulative x{calls:<5d} {name[:90]}")
        out[name[:90]] = 1e3 * own
    return out


def phase_windows(timer: PhaseTimer, iters: int, label: str,
                  loop: str = "CG loop") -> dict:
    """An unprofiled run's execution split into the prologue before its
    outer loop, the loop (the longest while-loop window, less the set-up
    windows of a compressed X inside it: its compression at loop entry
    and the first builds of its device forms) and the epilogue after it,
    each on the host clock and in device time between CUDA events; and
    that set-up apart. Prints and returns them."""
    (ex_h, ex_d, ex_t0, ex_t1, ex_e0, ex_e1), = timer.windows["execute"]
    # a script without a while loop: its longest for loop, or its whole
    # execution, is the "loop"
    lp_h, lp_d, lp_t0, lp_t1, lp_e0, lp_e1 = max(
        timer.windows["loop"] or timer.windows["for"]
        or timer.windows["execute"])
    comp = [w for label in PhaseTimer.SETUP for w in timer.windows[label]
            if lp_t0 <= w[2] and w[3] <= lp_t1]
    comp_h, comp_d = sum(w[0] for w in comp), sum(w[1] for w in comp)
    lp_h, lp_d = lp_h - comp_h, lp_d - comp_d
    out = {"execute_host_ms": ex_h, "execute_device_window_ms": ex_d,
           "prologue_host_ms": 1e3 * (lp_t0 - ex_t0),
           "prologue_device_window_ms": ex_e0.elapsed_time(lp_e0),
           "loop_host_ms": lp_h, "loop_device_window_ms": lp_d,
           "compress_host_ms": comp_h, "compress_device_window_ms": comp_d,
           "epilogue_host_ms": 1e3 * (ex_t1 - lp_t1),
           "epilogue_device_window_ms": lp_e1.elapsed_time(ex_e1),
           "iteration_ms": lp_d / max(iters, 1),
           "iteration_host_ms": lp_h / max(iters, 1)}
    print(f"[windows] {label}, host clock / device window between "
          f"CUDA events: execution {ex_h:.3f} / {ex_d:.3f} ms = prologue "
          f"{out['prologue_host_ms']:.3f} / "
          f"{out['prologue_device_window_ms']:.3f} + loop-entry "
          f"compression and device layouts {comp_h:.3f} / {comp_d:.3f} + "
          f"{loop} {lp_h:.3f} / "
          f"{lp_d:.3f} + epilogue {out['epilogue_host_ms']:.3f} / "
          f"{out['epilogue_device_window_ms']:.3f}; {loop} "
          f"{out['iteration_ms']:.3f} ms per iteration over {iters}")
    return out


# device_ms calls whose profiled runs kept dropping kernel records and
# that fell back to CUDA events (printed in the kernels line)
DEVICE_MS_FALLBACKS = []


def device_ms(fn, reps: int = 50, cold: bool = False) -> float:
    """Device time per call of fn: the kernels the card ran for `reps`
    calls under torch.profiler (device activity only), summed, over
    `reps`. A call whose host time exceeds its device time leaves the card
    idle between calls; CUDA events around the calls would measure the
    host then, this measures the card. With `cold`, a 128 MB write before
    each call evicts the 50 MB L2 cache (inputs of tens of MB stay in it
    across back-to-back calls), and only the spoof kernels count. The
    profiler at times records only some of the kernels (fewer than one a
    call): such a run is taken again, up to three times, and then the
    time is CUDA events around each call (the L2 write outside them),
    counted in DEVICE_MS_FALLBACKS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(32 * 2**20, device="cuda") if cold else None
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        ks = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and (not cold or "spoof" in e.name)]
        if len(ks) >= reps:
            return sum(ks) / 1e3 / reps
    pairs = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    DEVICE_MS_FALLBACKS.append(getattr(fn, "__qualname__", "?"))
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _kernel_name(line: str) -> str:
    """A ptxas "Compiling entry function" line's kernel, shortened: its
    name in spoof.cuh (or the mangled symbol's head) and its dtype."""
    import re

    sym = line.split("'")[1] if "'" in line else line
    m = re.match(r"_ZN5spoof\d+([A-Za-z_]+?)I([fd])", sym)
    if m:
        return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}>"
    # a kernel in a source's anonymous namespace: its name, and the head
    # of its template arguments
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", sym)
    if m:
        n = int(m.group(1))
        return sym[m.end():m.end() + n] + sym[m.end() + n:m.end() + n + 8]
    return sym[:60]


def print_build_reports(build, only: str = "") -> None:
    """Per source (those whose name starts with `only`), nvcc's seconds
    and ptxas's report by kernel: registers, spills, stack, shared
    memory."""
    for src, (secs, report) in sorted(build.build_reports.items()):
        if not src.startswith(only):
            continue
        rows, name = [], None
        for ln in report.splitlines():
            if "Compiling entry function" in ln:
                name = _kernel_name(ln)
            elif name and ("registers" in ln or "spill" in ln):
                rows.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
        print(f"[build] {src}: nvcc {secs:.1f} s, {len(rows)} ptxas lines")
        for row in rows:
            print(f"[build]   {row}")
    sys.stdout.flush()


# --------------------------------------------------------------------------
# the paths
# --------------------------------------------------------------------------

def make_data(dev):
    """X (M, K) fp32 and every script's targets, from one seeded
    generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=gen, device=dev)
    beta_true = torch.randn(K, 1, generator=gen, device=dev)
    w_svm = torch.randn(K, 1, generator=gen, device=dev)
    z = x @ w_svm + 0.1 * torch.randn(M, 1, generator=gen, device=dev)
    y_svm = torch.where(z >= 0, 1.0, -1.0)
    w_mlr = torch.randn(K, 1, generator=gen, device=dev)
    z = x @ w_mlr + torch.randn(M, 1, generator=gen, device=dev)
    ranks = torch.argsort(torch.argsort(z[:, 0]))
    y_mlr = (1 + (ranks * 5) // M).to(torch.float32).reshape(-1, 1)
    # GLM's targets: Poisson(2) counts, i.i.d.; and probit labels,
    # Bernoulli(pnorm(X w / sqrt(K)))
    y_pois = torch.poisson(torch.full((M, 1), 2.0, device=dev),
                           generator=gen)
    w_probit = torch.randn(K, 1, generator=gen, device=dev)
    p = torch.special.ndtr(x @ w_probit / math.sqrt(K))
    y_probit = (torch.rand(M, 1, generator=gen, device=dev) < p).to(
        torch.float32)
    return {"X": x, "beta_true": beta_true, "y": x @ beta_true,
            "Y_svm": y_svm, "Y_mlr": y_mlr, "y_pois": y_pois,
            "y_probit": y_probit,
            "Y_onehot": torch.nn.functional.one_hot(
                y_mlr[:, 0].long() - 1, 5).to(torch.float32)}


# name -> (script, inputs from make_data, args, output, what a line of its
# output says about its outer iterations, the loop's name); the last four
# are the algorithm-breadth paths, with scripts/perftest/run_perftest.py's
# arguments (regression1, regression2, clustering; Kmeans with verb 1, so
# that it prints its iterations)
PATHS = {
    "LinearRegCG": ("LinearRegCG.dml", {"X": "X", "y": "y"},
                    {"maxi": 20, "tol": 1e-9, "reg": 1e-6}, "beta",
                    "LinearRegCG: iterations = ", "CG loop"),
    "l2-svm": ("l2-svm.dml", {"X": "X", "Y": "Y_svm"}, {"maxiter": 15}, "w",
               "l2-svm: iter ", "outer loop"),
    "MultiLogReg": ("MultiLogReg.dml", {"X": "X", "Y_vec": "Y_mlr"},
                    {"moi": 10}, "B",
                    "MultiLogReg: Newton iterations = ", "Newton loop"),
    "LinearRegDS": ("LinearRegDS.dml", {"X": "X", "y": "y"}, {"reg": 1e-3},
                    "beta", None, "whole script"),
    "GLM-poisson": ("GLM.dml", {"X": "X", "y": "y_pois"},
                    {"dfam": 1, "vpow": 1.0, "link": 1, "lpow": 0.0,
                     "moi": 10, "tol": 1e-8, "reg": 1e-3}, "beta",
                    "GLM: IRLS iterations = ", "IRLS loop"),
    "GLM-probit": ("GLM.dml", {"X": "X", "y": "y_probit"},
                   {"dfam": 2, "link": 3, "moi": 10, "tol": 1e-8,
                    "reg": 1e-3}, "beta",
                   "GLM: IRLS iterations = ", "IRLS loop"),
    "Kmeans": ("Kmeans.dml", {"X": "X"},
               {"k": 5, "maxi": 10, "runs": 1, "verb": 1}, "C_out",
               "Kmeans run 1: WCSS = ", "Lloyd loop"),
    "minibatch-sgd": (None, {"X": "X", "Y": "Y_onehot"},
                      {"bs": 1000, "lr": 0.2}, "W",
                      "minibatch-sgd: iterations = ", "SGD loop"),
}
# the training body of scripts/nn/examples/mnist_softmax.dml (affine,
# softmax, cross-entropy and SGD of scripts/nn/layers/, inlined) with
# end = beg + bs - 1, and inverted dropout on each batch's rows
# (scripts/nn/layers/dropout.dml) from a seed that changes with i: the
# slices at a device offset, the loop-varying seed, one epoch; W starts
# at 0 (rand(pdf="normal") waits for queue 1 item 8)
# its one fused plan at optlevel 3, a row template (K4): dscores' row sum
MINIBATCH_ROW_PLAN = (
    "b(*)(b(/)(u(-)(b(/)(i0, b(+)(b(/)(u(exp)(b(-)(b(+)(i1, i2), i3)), "
    "i4), 1e-10))), 1000.0), b(/)(u(exp)(b(-)(b(+)(i5, i6), i7)), i8))")
# the block compile's one plan for Kmeans at optlevel 3, a row template
# (K4): row_norms = rowSums(X ^ 2)
KMEANS_ROW_PLAN = "b(^)(i0, 2.0)"
MINIBATCH_SGD = """
bs = $bs
lr = $lr
N = nrow(X)
D = ncol(X)
K = ncol(Y)
W = rand(rows=D, cols=K, pdf="normal", seed=42) * sqrt(1.0 / D)
b = matrix(0, rows=1, cols=K)
iters = N %/% bs
masks = matrix(0, rows=iters, cols=bs)
for (i in 1:iters) {
  beg = (i-1)*bs + 1
  end = beg + bs - 1
  X_batch = X[beg:end,]
  Y_batch = Y[beg:end,]
  mask = rand(rows=bs, cols=1, min=1, max=1, sparsity=0.9, seed=7 + i)
  Xd = X_batch * mask / 0.9
  scores = Xd %*% W + b
  e = exp(scores - rowMaxs(scores))
  probs = e / rowSums(e)
  dprobs = -(Y_batch / (probs + 1e-10)) / bs
  dscores = probs * (dprobs - rowSums(dprobs * probs))
  dW = t(Xd) %*% dscores
  db = colSums(dscores)
  W = W - lr * dW
  b = b - lr * db
  masks[i, ] = t(mask)
}
print("minibatch-sgd: iterations = " + iters)
"""
# its dropout draw (a variant without it shows the draw's share)
MINIBATCH_MASK = ("mask = rand(rows=bs, cols=1, min=1, max=1, sparsity=0.9, "
                  "seed=7 + i)")
# the paths of PR 1-2, and the algorithm-breadth paths
DENSE_PATHS = ("LinearRegCG", "l2-svm", "MultiLogReg")
BREADTH_PATHS = ("LinearRegDS", "GLM-poisson", "GLM-probit", "Kmeans")
# each path's output shape, where it is not K rows
OUT_SHAPES = {"Kmeans": (5, K)}
# paths whose fused plans may take the plain arm by layout, and why: the
# JAX package's kernel refuses the same leaf layouts (its jnp arm)
PLAIN_BY_LAYOUT = {
    "Kmeans": "D = row_norms - 2 * (X %*% t(C)) + t(rowSums(C ^ 2)) is a "
              "row plan whose (m, 1) main leaf stands beside the (m, k) "
              "distances"}


def path_script(name, data, rows=None, args=None, extra=(), src=None):
    """The path's script with its inputs; `src` replaces an inline
    script's text (minibatch-sgd's)."""
    from systemml_tpu_torch.api.mlcontext import dml, dmlFromFile

    script, inputs, path_args, out, _, _ = PATHS[name]
    s = (dml(src or MINIBATCH_SGD) if script is None
         else dmlFromFile(os.path.join(ALG, script)))
    for k, v in inputs.items():
        s.input(k, data[v] if rows is None else data[v][:rows])
    for k, v in dict(path_args, **(args or {})).items():
        s.arg(k, v)
    return s.output(out, *extra)


def outer_iterations(name, lines) -> int:
    marker = PATHS[name][4]
    if marker is None:
        return 1          # no loop: the whole execution is one unit
    hits = [s for s in lines if s.startswith(marker)]
    if name == "l2-svm":
        return len(hits)
    if not hits:
        fail(f"{name} printed no iteration count")
    if name == "Kmeans":  # "Kmeans run 1: WCSS = w (n iters)"
        return int(hits[-1].rsplit("(", 1)[1].split()[0])
    return int(hits[-1].split(marker)[1].split(",")[0])


def config(optlevel: int, regions: bool = True):
    from systemml_tpu_torch.utils.config import DMLConfig

    cfg = DMLConfig()
    cfg.optlevel = optlevel
    cfg.codegen_enabled = regions
    return cfg


# the one reason each path's loop may be refused for, by its class (the
# text before any colon): Kmeans's k-means++ init loop grows C by a row
# each iteration (C = rbind(C, S[pick, ])), which is what makes the JAX
# package's own fused loop fall back; its Lloyd while loop is a region.
# The rest run whole: l2-svm's outer loop with its print (the device
# ring), LinearRegCG-cla's CG loop over the compressed X
REFUSAL = {"Kmeans": "shape change"}
# paths without a loop: no region to run
NO_LOOP = ("LinearRegDS",)
# paths whose fused plans at optlevel 3 are row plans only (K4, no K2)
ROW_ONLY = ("minibatch-sgd",)
# paths whose printed lines with regions must equal the eager run's
PRINTS = ("l2-svm",)


def region_report(timer: PhaseTimer, label: str, path: str,
                  regions: bool, may_refuse: str = None) -> dict:
    """What the region executor recorded in the run `timer` watched
    (runtime/loopfuse.region_report of the program it executed): the
    regions planned, captured and refused with their reasons, the graph
    launches and host syncs per loop entry, the trips, and the kernel
    launches per body of the last launch; the capture's host time and
    the launches' device windows. Prints one `regions` line, and fails
    when a region is refused for anything but REFUSAL[path], when a
    region that runs is not one launch and two host syncs per entry, or
    when a run without regions planned any. `may_refuse`: a reason a
    region of the path may be refused for, but need not be."""
    from systemml_tpu_torch.runtime import loopfuse

    rep = loopfuse.region_report(timer.program)
    if not regions:
        if rep:
            fail(f"{label}: codegen_enabled is False, yet {len(rep)} regions")
        return {}
    refused = {r["label"]: r.get("refused") or r["planned_refused"]
               for r in rep if r.get("refused") or r["planned_refused"]}
    want = REFUSAL.get(path)
    for lab, why in refused.items():
        if why.split(":")[0] != want and why != may_refuse:
            fail(f"{label}: region {lab} refused ({why!r}); the only reason "
                 f"this path may be refused for is {want!r}")
    if want is not None and not refused:
        fail(f"{label}: no region refused, {want!r} expected")
    ran = [r for r in rep if r.get("entries") and r["label"] not in refused]
    if path in NO_LOOP and rep:
        fail(f"{label}: {len(rep)} regions planned in a script without loops")
    if path not in REFUSAL and path not in NO_LOOP and not ran:
        fail(f"{label}: no region ran")
    if path == "Kmeans" and not ran:
        fail(f"{label}: the Lloyd while loop did not run as a region")
    for r in ran:
        # a launch per entry that ran an iteration, and one per drain of
        # the print ring; a sync per launch, and per while entry its test
        runs = [t for t in r["trips"] if t]
        tests = r["entries"] if r["label"].startswith("while") else 0
        if r["launches"] != len(runs) + r["drains"] or r["host_syncs"] - \
                r["static_reads"] != tests + r["launches"]:
            fail(f"{label}: region {r['label']}: {r['launches']} graph "
                 f"launches, {r['drains']} drains and {r['host_syncs']} "
                 f"host syncs in {r['entries']} entries")
    cap_ms = sum(w[0] for w in timer.windows["capture"])
    launch_ms = sum(w[1] for w in timer.windows["launch"])
    graph_trips = sum(sum(r["trips"]) - r["captures"] for r in ran)
    out = {"planned": sum(1 for r in rep if not r["inlined"]),
           "captured": sum(r.get("captures", 0) for r in rep),
           "refused": refused,
           "entries": sum(r.get("entries", 0) for r in rep),
           "graph_launches": sum(r.get("launches", 0) for r in rep),
           "drains": sum(r.get("drains", 0) for r in rep),
           "host_syncs": sum(r.get("host_syncs", 0) for r in rep),
           "capture_host_ms": cap_ms, "launch_device_ms": launch_ms,
           "graph_trips": graph_trips,
           "graph_iteration_ms": launch_ms / graph_trips if graph_trips
           else float("nan"),
           "regions": [{k: r.get(k) for k in ("label", "entries", "captures",
                                              "launches", "drains",
                                              "host_syncs", "static_reads",
                                              "trips", "bodies", "nodes",
                                              "views")}
                       for r in rep if r.get("entries")]}
    per = "; ".join(
        f"{r['label']}: {r['entries']} entries, "
        f"{r['launches'] / r['entries']:.2f} graph launches, "
        f"{r['drains'] / r['entries']:.2f} print-ring drains and "
        f"{r['host_syncs'] / r['entries']:.2f} host syncs per entry "
        f"({r['static_reads']} of them reads of shape invariants), trips "
        f"{r['trips'][:6]}{'...' if len(r['trips']) > 6 else ''}, kernel "
        f"launches per body {r.get('bodies')}"
        for r in out["regions"])
    print(f"[regions] {label}: planned {out['planned']}, captured "
          f"{out['captured']}, refused {refused or 'none'}; {per}; capture "
          f"{cap_ms:.1f} ms host; graph launches {launch_ms:.3f} ms device "
          f"over {graph_trips} iterations in graphs "
          f"({out['graph_iteration_ms']:.3f} ms per iteration)", flush=True)
    return out


class SyncAudit:
    """Holds the region executor's record["host_syncs"] to the
    synchronizing CUDA calls that torch reports under
    torch.cuda.set_sync_debug_mode("warn"), in two scopes of each region
    that runs: FusedLoop._loop (the launches, the print ring's drains,
    the exit), and a whole FusedLoop._enter that met its cache (no peel
    or capture, whose uploads of set-up data are synchronous copies).
    In each, the calls torch saw must equal the calls the record counted;
    a nested region's calls are its own. Per thread: each parfor lane
    keeps its own stack of open scopes, torch's warning reaches the scope
    of the thread that made the call (a call outside any scope is not
    counted), and the mode is "warn" while a scope is open in any thread;
    a lane holds a region from its entry to its exit
    (runtime/loopfuse.py), so the record's count in a scope is the
    lane's. `finish` prints one `[syncs]` line, with the scopes and calls
    per parfor lane, and fails on any difference."""

    SYNC = "called a synchronizing CUDA operation"

    def __init__(self):
        import threading
        import warnings

        from systemml_tpu_torch.runtime import loopfuse

        self.loopfuse = loopfuse
        self.cls = loopfuse.FusedLoop
        self.orig = {m: getattr(self.cls, m) for m in ("_enter", "_loop")}
        self.local = threading.local()
        self.lock = threading.Lock()
        self.open = 0
        self.calls = {m: 0 for m in self.orig}
        self.seen = {m: 0 for m in self.orig}
        self.lanes = {}
        self.bad = []
        self.filters = warnings.filters[:]
        self.show = warnings.showwarning
        warnings.filterwarnings("always", message=".*" + self.SYNC)
        warnings.showwarning = self._show
        for m, fn in self.orig.items():
            setattr(self.cls, m, self._wrap(m, fn))

    def _stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def _show(self, message, category, filename, lineno, *args, **kwargs):
        if self.SYNC in str(message):
            st = self._stack()
            if st:
                st[-1]["seen"] += 1
            return
        self.show(message, category, filename, lineno, *args, **kwargs)

    def _mode(self, d: int) -> None:
        """Opens (d=1) or closes (d=-1) a scope: the mode is "warn" while
        any thread has one open."""
        with self.lock:
            self.open += d
            if d > 0 and self.open == 1:
                torch.cuda.set_sync_debug_mode("warn")
            elif d < 0 and self.open == 0:
                torch.cuda.set_sync_debug_mode(0)

    def _wrap(self, m, fn):
        audit = self

        def wrapped(fl, *args, **kwargs):
            rec = fl.record
            h0, c0 = rec["host_syncs"], rec["captures"]
            frame = {"fl": fl, "seen": 0}
            stack = audit._stack()
            stack.append(frame)
            audit._mode(1)
            try:
                out = fn(fl, *args, **kwargs)
            finally:
                audit._mode(-1)
                stack.pop()
            if stack and stack[-1]["fl"] is fl:
                stack[-1]["seen"] += frame["seen"]
            counted = rec["host_syncs"] - h0
            if rec.get("refused") is None and (
                    m == "_loop" or rec["captures"] == c0):
                lane = audit.loopfuse.current_lane()
                with audit.lock:
                    audit.calls[m] += 1
                    audit.seen[m] += frame["seen"]
                    per = audit.lanes.setdefault(
                        "caller" if lane is None else lane,
                        {"scopes": 0, "seen": 0, "counted": 0})
                    per["scopes"] += 1
                    per["seen"] += frame["seen"]
                    per["counted"] += counted
                    if frame["seen"] != counted:
                        lab = getattr(getattr(fl, "region", None), "label",
                                      "?")
                        audit.bad.append(
                            f"{m} of {lab} (lane {lane}): torch saw "
                            f"{frame['seen']} synchronizing calls, the "
                            f"record counted {counted}")
            return out

        return wrapped

    def finish(self) -> dict:
        import warnings

        for m, fn in self.orig.items():
            setattr(self.cls, m, fn)
        warnings.showwarning = self.show
        warnings.filters[:] = self.filters
        lanes = {str(k): v for k, v in sorted(
            self.lanes.items(), key=lambda kv: str(kv[0]))}
        print(f"[syncs] synchronizing CUDA calls (sync debug mode warn) in "
              f"{self.calls['_loop']} region loops (launches, drains, exit): "
              f"{self.seen['_loop']}; in {self.calls['_enter']} whole entries "
              f"that met their cache: {self.seen['_enter']}; per parfor lane "
              f"(scopes, calls torch saw, calls the records counted): "
              f"{lanes}; differences from the records' host_syncs: "
              f"{self.bad or 'none'}", flush=True)
        if self.bad:
            fail(f"host_syncs miscounted: {self.bad[:3]}")
        return {"loops": self.calls["_loop"], "loop_syncs": self.seen["_loop"],
                "cached_entries": self.calls["_enter"],
                "cached_entry_syncs": self.seen["_enter"], "lanes": lanes}


def compare_eager(label: str, reg: dict, eag: dict, key: str = "out"):
    """A run with regions against the same run without: its output bit for
    bit, or within 1e-5 normwise (fp32; the sums under a capture may run in
    another order), and every kernel's launch count equal. Prints the ms
    per iteration of both, the region's busy share (the eager run's kernel
    time per loop period over the region's ms per iteration in its graph)
    and the peak memory."""
    a, b = reg[key], eag[key]
    same = bool(torch.equal(a, b))
    diff = float(torch.linalg.norm(a.double() - b.double())
                 / torch.linalg.norm(b.double()))
    la = {k: v for k, v in reg["launches"].items() if k != "set_cond"}
    lb = {k: v for k, v in eag["launches"].items() if k != "set_cond"}
    gi = reg["regions"].get("graph_iteration_ms", float("nan"))
    prof = eag.get("profile") or {}
    busy = (prof["cg_loop_busy_share"] * prof["cg_iteration_ms"] / gi
            if "cg_iteration_ms" in prof and gi == gi else float("nan"))
    out = {"bit_identical": same, "normwise": diff,
           "iteration_ms_regions": gi,
           "iteration_ms_regions_with_peel_and_capture":
               reg["windows"]["iteration_ms"],
           "iteration_ms_eager": eag["windows"]["iteration_ms"],
           "busy_share_regions": busy,
           "busy_share_eager": prof.get("cg_loop_busy_share"),
           "peak_allocated": (reg["peak_bytes"], eag["peak_bytes"]),
           "peak_reserved": (reg["peak_reserved"], eag["peak_reserved"])}
    print(f"[eager] {label}: with regions / without: bit-identical {same}, "
          f"normwise {diff:.3e} (bar 1e-5 where not bit-identical); ms per "
          f"iteration {gi:.3f} in the graph "
          f"({reg['windows']['iteration_ms']:.3f} with the peeled iteration "
          f"and the capture) / {eag['windows']['iteration_ms']:.3f}; busy "
          f"share {100 * busy:.1f}% / "
          f"{100 * (prof.get('cg_loop_busy_share') or float('nan')):.1f}%; "
          f"peak allocated {reg['peak_bytes'] / 1e9:.3f} / "
          f"{eag['peak_bytes'] / 1e9:.3f} GB, reserved "
          f"{reg['peak_reserved'] / 1e9:.3f} / "
          f"{eag['peak_reserved'] / 1e9:.3f} GB; launches {la} / {lb}",
          flush=True)
    if not same and not diff <= 1e-5:
        fail(f"{label}: with regions {diff} from without (bar 1e-5)")
    if la != lb:
        fail(f"{label}: kernel launches with regions {la}, without {lb}")
    if label.split()[0] in PRINTS:
        same_lines = reg["lines"] == eag["lines"]
        print(f"[eager] {label}: {len(reg['lines'])} lines printed with "
              f"regions (the print ring), {len(eag['lines'])} without, equal "
              f"in order {same_lines}", flush=True)
        if not same_lines:
            fail(f"{label}: the lines printed with regions differ from the "
                 f"eager run's")
        out["lines_equal"] = same_lines
    return out


def check_print_lines(label, run) -> None:
    """A region run of a path that prints once per outer iteration: one
    line per iteration of its outer region (the lines come through the
    print ring after each launch)."""
    top = [r for r in run["regions"]["regions"] if r["label"].endswith("@0")]
    trips = sum(sum(r["trips"]) for r in top)
    drains = sum(r["drains"] for r in top)
    print(f"[regions] {label}: {len(run['lines'])} lines printed over "
          f"{trips} iterations of the outer region, {drains} drains of "
          f"its print ring", flush=True)
    if len(top) != 1 or len(run["lines"]) != trips:
        fail(f"{label}: {len(run['lines'])} lines over {trips} iterations "
             f"of {len(top)} outer regions")


def minibatch_paths(data, dev, kernels) -> dict:
    """minibatch-sgd on the dense X: optlevel 3 with regions and without,
    optlevel 2 with regions. W with regions within 1e-5 normwise of the
    eager run (or equal), the launches equal; each run's per-iteration
    masks, all 2,000 as the script's `masks` rows, equal to the CPU's
    draw for the same seeds, bit for bit."""
    from systemml_tpu_torch.ops import datagen

    name = "minibatch-sgd"
    extra = ("masks",)
    runs = {"optlevel3": run_path(name, 3, data, dev, kernels, extra=extra),
            "optlevel3_eager": run_path(name, 3, data, dev, kernels,
                                        regions=False, extra=extra),
            "optlevel2": run_path(name, 2, data, dev, kernels, extra=extra)}
    out = {"versus_eager": compare_eager(f"{name} optlevel 3",
                                         runs["optlevel3"],
                                         runs["optlevel3_eager"])}
    bs = PATHS[name][2]["bs"]
    iters = M // bs
    masks = [datagen.rand(bs, 1, 1.0, 1.0, 0.9, seed=7 + i,
                          dtype=torch.float32, device="cpu")
             for i in range(1, iters + 1)]
    want = torch.cat(masks, 1).T
    for label, r in runs.items():
        got = r["extra"]["masks"].cpu()
        same = bool(torch.equal(got, want))
        a = r["out"].double()
        diff = float(torch.linalg.norm(a - runs["optlevel3_eager"]["out"]
                                       .double()) / torch.linalg.norm(a))
        print(f"[minibatch] {label}: {r['iterations']} iterations, "
              f"{r['windows']['iteration_ms']:.4f} ms per iteration; masks "
              f"(all {iters}, bit for bit) equal to the CPU's "
              f"draw {same}; |W - W eager optlevel 3| / |W| {diff:.3e}; "
              f"launches {r['launches']}; regions "
              f"{r['regions'].get('graph_launches')} graph launches, "
              f"{r['regions'].get('host_syncs')} host syncs", flush=True)
        if not same:
            fail(f"{name} {label}: the dropout masks differ from the CPU's")
        if r["iterations"] != iters:
            fail(f"{name} {label}: {r['iterations']} iterations, not {iters}")
        if not diff <= 1e-3:
            fail(f"{name} {label}: W is {diff} from the eager run's")
        out[label] = {k: v for k, v in r.items()
                      if k not in ("out", "lines", "extra")}
    # where the graph's time goes: the loop without its dropout draw, and
    # one draw (threefry as torch integer ops) replayed as a graph alone
    plain = run_path(name, 3, data, dev, kernels, src=MINIBATCH_SGD.replace(
        MINIBATCH_MASK, "mask = matrix(1, rows=bs, cols=1)"))
    seed = torch.full((), 7 + iters, dtype=torch.int64, device=dev)
    draw = lambda: datagen.rand(bs, 1, 1.0, 1.0, 0.9, seed=seed,
                                dtype=torch.float32, device=dev)
    draw()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mask = draw()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(mask.cpu(), masks[-1]):
        fail(f"{name}: a draw replayed as a graph differs from the CPU's")
    draw_graph_ms, draw_eager_ms = time_ms([graph.replay, draw])
    it = runs["optlevel3"]["regions"]["graph_iteration_ms"]
    it_plain = plain["regions"]["graph_iteration_ms"]
    print(f"[minibatch] where the graph's time goes: {it:.4f} ms per "
          f"iteration, {it_plain:.4f} without the dropout draw; one draw "
          f"of a ({bs}, 1) mask from a device seed {draw_graph_ms:.4f} ms "
          f"replayed as a graph alone, {draw_eager_ms:.4f} ms eagerly "
          f"(CUDA events over back-to-back calls)", flush=True)
    out["iteration_ms_without_draw"] = it_plain
    out["draw_graph_ms"], out["draw_eager_ms"] = draw_graph_ms, draw_eager_ms
    return out


def compile_paths(data, names=tuple(PATHS)):
    """The paths' programs at optlevel 3 on the card; compile_program
    builds each program's fused plans, one nvcc per source, all of a
    program's together."""
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.config import get_config, set_config

    old = get_config()
    set_config(config(3))
    try:
        progs = {}
        for name in names:
            s = path_script(name, data)
            progs[name] = compile_program(
                s.parse(), clargs=s._args, outputs=s._outputs,
                input_names=list(s._inputs))
        return progs
    finally:
        set_config(old)


def reset_launches(kernels) -> None:
    from systemml_tpu_torch.compress import device as cla_dev

    from systemml_tpu_torch.codegen import loop_graph

    for k in (kernels.mmchain_kernel, kernels.cell_kernel,
              kernels.row_kernel, kernels.outer_kernel,
              kernels.multiagg_kernel, cla_dev.chain_kernel,
              loop_graph.set_cond):
        k.launches = 0


def read_launches(kernels) -> dict:
    from systemml_tpu_torch.compress import device as cla_dev

    from systemml_tpu_torch.codegen import loop_graph

    return {"mmchain": kernels.mmchain_kernel.launches,
            "spoof_cell": kernels.cell_kernel.launches,
            "spoof_row": kernels.row_kernel.launches,
            "spoof_outer": kernels.outer_kernel.launches,
            "spoof_multiagg": kernels.multiagg_kernel.launches,
            "cla_chain": cla_dev.chain_kernel.launches,
            "set_cond": loop_graph.set_cond.launches}


def run_path(name, optlevel, data, dev, kernels, regions=True,
             profile_kernel=None, args=None, extra=(), src=None):
    """One unprofiled run of a path through MLContext, after a warm-up on
    the first 8,192 rows; the launch counters are set to 0 just before it
    and read just after. `regions` False runs it with codegen_enabled
    False (every loop eager); with `profile_kernel`, once more under
    torch.profiler (its loop period from that kernel's launches). `args`
    override the path's arguments; `extra` names more outputs, returned
    under "extra"; `src` the text of an inline script's variant."""
    from systemml_tpu_torch.api.mlcontext import MLContext

    ml = MLContext(config(optlevel, regions))
    ml.printer = lambda s: None
    ml.execute(path_script(name, data, rows=8192, args=args, extra=extra,
                           src=src))
    lines = []
    ml.printer = lines.append
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        res = ml.execute(path_script(name, data, args=args, extra=extra,
                                     src=src))
        out = res.get_tensor(PATHS[name][3])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    iters = outer_iterations(name, lines)
    events = dict(ml._stats.estim_counts.items())
    tag = f"{name} optlevel {optlevel}" + ("" if regions else " eager")
    windows = phase_windows(timer, iters, tag, PATHS[name][5])
    reg = region_report(timer, tag, name, regions)
    for s in lines[-2:]:
        print(f"[script] {s}")
    print(f"[path] {name} optlevel {optlevel}: {iters} outer iterations, "
          f"{secs:.3f} s with parse and compile, {ml._stats.run_time:.3f} s "
          f"executing; {windows['iteration_ms']:.3f} ms per outer iteration "
          f"(device window; host {windows['iteration_host_ms']:.3f} ms); "
          f"launches {launches}; {walk_line(events)}; spoof_plain_by_layout "
          f"{events.get('spoof_plain_by_layout', 0)}, spoof_compile_errors "
          f"{events.get('spoof_compile_errors', 0)}; peak allocated "
          f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB over the data "
          f"already on the card), reserved {peak_reserved / 1e9:.2f} GB",
          flush=True)
    check_walks(f"{name} optlevel {optlevel}", events, launches)
    shape = OUT_SHAPES.get(name)
    if not bool(torch.isfinite(out).all()) or (
            tuple(out.shape) != shape if shape else out.shape[0] != K):
        fail(f"{name} optlevel {optlevel}: output of shape "
             f"{tuple(out.shape)} is not finite or not "
             f"{shape or f'{K} rows'}")
    if out.dtype != torch.float32 or out.device.type != "cuda":
        fail(f"{name}: output is {out.dtype} on {out.device}")
    if events.get("spoof_compile_errors", 0):
        fail(f"{name} optlevel {optlevel}: spoof_compile_errors "
             f"{events['spoof_compile_errors']}")
    if optlevel >= 3:
        if events.get("spoof_plain_by_layout", 0) and \
                name not in PLAIN_BY_LAYOUT:
            fail(f"{name}: {events['spoof_plain_by_layout']} fused plans "
                 f"took the plain arm by layout")
        if launches["spoof_cell"] < 1 and name not in ROW_ONLY:
            fail(f"{name} optlevel 3: the spoof cell kernel never launched")
        if name in ("MultiLogReg", "Kmeans") + ROW_ONLY and \
                launches["spoof_row"] < 1:
            fail(f"{name} optlevel 3: the spoof row kernel never launched")
    elif launches["spoof_cell"] or launches["spoof_row"]:
        fail(f"{name} optlevel {optlevel} launched spoof kernels")
    if launches["cla_chain"] or events.get("cla_auto_compressed", 0):
        fail(f"{name} optlevel {optlevel}: the dense X was compressed")
    st = ml._stats
    # getattr: --bench runs this file in an earlier tree too, whose
    # Statistics have no block compile
    blocks = {"fused": getattr(st, "fused_blocks", 0),
              "eager": st.eager_blocks,
              "plans": getattr(st, "compile_count", 0),
              "eager_by_reason": dict(getattr(st, "eager_reasons", {})),
              "graphs": dict(getattr(st, "block_graph_counts", {})),
              "block_spoof_plans": events.get("block_spoof_plans", 0)}
    result = {"out": out, "iterations": iters, "seconds": secs,
              "exec_seconds": ml._stats.run_time, "launches": launches,
              "blocks": blocks,
              "peak_bytes": peak, "peak_reserved": peak_reserved,
              "peak_over_data": peak - base,
              "extra": {e: res.get(e) for e in extra},
              "windows": windows, "lines": lines, "regions": reg,
              "events": {k: v for k, v in events.items()
                         if k.startswith("spoof_")}}
    if profile_kernel:
        result["profile"] = profile_main_path(ml, path_script(name, data),
                                              False, kernel=profile_kernel,
                                              loop=PATHS[name][5])
    return result


# --------------------------------------------------------------------------
# the algorithm-breadth paths: LinearRegDS, GLM (poisson, probit), Kmeans
# --------------------------------------------------------------------------

def glm_deviances(log: str) -> list:
    """The deviances of GLM.dml's IRLS log, "OBJECTIVE,iter,deviance"."""
    return [float(ln.split(",")[2]) for ln in log.split("\n")
            if ln.startswith("OBJECTIVE,")]


def kmeans_replay(x, c1, iters: int):
    """Kmeans.dml's Lloyd iterations in plain torch in fp64, from the
    centroids c1: the distances by the gram trick, the first nearest
    centroid, the per-cluster means (an empty cluster keeps its centroid).
    Returns the centroids after `iters` updates and the WCSS (the sum of
    each row's least distance) before each update."""
    xd = x.double()
    row_norms = (xd * xd).sum(1, keepdim=True)
    c = c1.double()
    wcss = []
    for _ in range(iters):
        d = row_norms - 2 * (xd @ c.T) + (c * c).sum(1)[None, :]
        assign = torch.argmax(-d, dim=1)
        wcss.append(float(d.min(dim=1).values.sum()))
        a = torch.nn.functional.one_hot(assign, c.shape[0]).double()
        counts = a.sum(0)[:, None]
        c_new = (a.T @ xd) / counts.clamp(min=1)
        empty = (counts == 0).double()
        c = c_new * (1 - empty) + c * empty
        del d, a
    del xd
    return c, wcss


def _lloyd_update(x, assign, c):
    """Kmeans.dml's centroid update: per-cluster means, an empty cluster
    keeping its centroid."""
    a = torch.nn.functional.one_hot(assign, c.shape[0]).to(x.dtype)
    counts = a.sum(0)[:, None]
    empty = (counts == 0).to(x.dtype)
    return (a.T @ x) / counts.clamp(min=1) * (1 - empty) + c * empty


def kmeans_ties(x, c, c2, iters, kernels) -> dict:
    """Why Kmeans's C_out at optlevel 3 differs from optlevel 2's: its
    row_norms = rowSums(X ^ 2) by each optlevel's arm (3: the block
    compile's K4 row plan; 2: X ^ 2 formed, then torch's row sum), each
    against fp64; the first update's centroids of the two optlevels (c,
    c2) against each other; from c, the rows whose nearest centroid under
    the script's fp32 distances (D = row_norms - 2 X t(C) + t(rowSums(C ^
    2))) differs between the two arms, or from fp64, and the rows whose
    two nearest centroids lie closer in fp64 than the arms' row norms
    differ; and `iters` Lloyd iterations in fp32 from c with each arm's
    row norms, the rows assigned otherwise at each, and how far apart
    their centroids end. Prints a `[kmeans-ties]` line; fails if an
    arm's row norms are further than SPOOF_BARS[fp32] from fp64."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml

    rn = {}
    for opt in (3, 2):
        ml = MLContext(config(opt))
        reset_launches(kernels)
        rn[opt] = ml.execute(dml("R = rowSums(X ^ 2)").input("X", x)
                             .output("R")).get_tensor("R")
        launched = read_launches(kernels)["spoof_row"]
        if launched != (1 if opt == 3 else 0):
            fail(f"[kmeans-ties] rowSums(X ^ 2) at optlevel {opt} launched "
                 f"K4 {launched} times")
    chunk = 250_000
    ref = torch.cat([x[i:i + chunk].double().pow(2).sum(1, keepdim=True)
                     for i in range(0, M, chunk)])
    errs = {o: float(torch.linalg.norm(rn[o].double() - ref)
                     / torch.linalg.norm(ref)) for o in rn}
    max_rel = {o: float(((rn[o].double() - ref).abs() / ref).max())
               for o in rn}
    delta = float((rn[3].double() - rn[2].double()).abs().max())
    cc = (c * c).sum(1)[None, :]
    xc = x @ c.T
    assign = {o: torch.argmin(rn[o] - 2 * xc + cc, dim=1) for o in rn}
    del cc
    a64, close = [], 0
    cd = c.double()
    ccd = (cd * cd).sum(1)[None, :]
    for i in range(0, M, chunk):
        d = ref[i:i + chunk] - 2 * (x[i:i + chunk].double() @ cd.T) + ccd
        a64.append(torch.argmin(d, dim=1))
        two = torch.topk(d, 2, dim=1, largest=False).values
        close += int(((two[:, 1] - two[:, 0]) <= delta).sum())
    a64 = torch.cat(a64)
    flips = int((assign[3] != assign[2]).sum())
    flips64 = {o: int((assign[o] != a64).sum()) for o in rn}
    del xc, assign, a64
    cs = {3: c, 2: c}
    by_iter = []
    for _ in range(iters):
        a = {o: torch.argmin(rn[o] - 2 * (x @ cs[o].T)
                             + (cs[o] * cs[o]).sum(1)[None, :], dim=1)
             for o in rn}
        by_iter.append(int((a[3] != a[2]).sum()))
        cs = {o: _lloyd_update(x, a[o], cs[o]) for o in rn}
    c_gap = normwise(cs[3], cs[2])
    c1_gap = normwise(c2, c)
    rec = {"row_norms_vs_fp64": errs, "row_norms_max_rel": max_rel,
           "max_abs_row_norm_gap": delta, "first_update_gap": c1_gap,
           "flips_3_vs_2": flips, "flips_vs_fp64": flips64,
           "rows_within_gap": close, "replay_flips_by_iteration": by_iter,
           "replay_c_gap": c_gap}
    print(f"[kmeans-ties] row_norms at ({M}, {K}) fp32 against fp64: K4 "
          f"(optlevel 3) normwise {errs[3]:.3e}, max relative "
          f"{max_rel[3]:.3e}; X ^ 2 then the row sum (optlevel 2) "
          f"{errs[2]:.3e}, {max_rel[2]:.3e} (bar {SPOOF_BARS[torch.float32]:g}"
          f"); the arms differ by {delta:.3e} at most; from the centroids of "
          f"the first update, {flips} rows take another nearest centroid "
          f"with K4's row norms than with optlevel 2's ({flips64[3]} and "
          f"{flips64[2]} against fp64), {close} rows have their two nearest "
          f"centroids within that {delta:.3e} in fp64; the first update's "
          f"centroids of the optlevels {c1_gap:.3e} apart; {iters} Lloyd "
          f"iterations in fp32 from them with each arm's row norms assign "
          f"{by_iter} rows otherwise at each, and end {c_gap:.3e} apart; "
          f"on {nvidia_smi_line()}", flush=True)
    if not max(errs.values()) <= SPOOF_BARS[torch.float32]:
        fail(f"[kmeans-ties] row norms {errs} from fp64")
    del ref, rn, cs
    torch.cuda.empty_cache()
    return rec


def _kmeans_wcss(lines) -> float:
    hit = [s for s in lines if s.startswith("Kmeans run 1: WCSS = ")][-1]
    return float(hit.split("= ")[1].split()[0])


def check_breadth_datagen(dev) -> dict:
    """seq and sample on the card against the CPU's draw, bit for bit, at
    the shapes Kmeans gives them (its k-means++ sample of 2,000,000 rows
    in steps of 8,000; its plain init's sample of 5 rows) and with
    replacement over 3,000,000 (three rounds of the sort shuffle)."""
    from systemml_tpu_torch.ops import datagen

    out = {}
    for label, fn, args in (
            ("sample(2000000, 5, 7)", datagen.sample, (2_000_000, 5, False, 7)),
            ("sample(3000000, 10, TRUE, 7)", datagen.sample,
             (3_000_000, 10, True, 7)),
            ("sample(3000000, 3000000, 7)", datagen.sample,
             (3_000_000, 3_000_000, False, 7)),
            ("seq(1, 2000000, 8000)", datagen.seq, (1, 2_000_000, 8000))):
        for dtype in (torch.float32, torch.float64):
            t0 = time.perf_counter()
            got = fn(*args, dtype=dtype, device=dev)
            torch.cuda.synchronize()
            card_ms = 1e3 * (time.perf_counter() - t0)
            ref = fn(*args, dtype=dtype, device="cpu")
            same = bool(torch.equal(got.cpu(), ref))
            out[f"{label} {str(dtype)[6:]}"] = {"bit_identical": same,
                                                "card_host_ms": card_ms}
            if not same:
                fail(f"{label} {dtype} on the card differs from the CPU's")
    print(f"[datagen] seq and sample on the card against the CPU, bit for "
          f"bit: {out}", flush=True)
    return out


def breadth_paths(data, dev, kernels) -> dict:
    """LinearRegDS, GLM-poisson, GLM-probit and Kmeans through MLContext on
    the card: each at optlevel 3 with regions, at optlevel 3 without
    (codegen_enabled False) and at optlevel 2; the with/without pair held
    to bit-identity or 1e-5 normwise with equal kernel launches, optlevel
    3 to optlevel 2 at 1e-3, and each path's own check (section 3 of the
    module docstring). Prints one `[breadth]` line per path."""
    beta_true = data["beta_true"].double()
    x = data["X"]
    out = {}
    for name in BREADTH_PATHS:
        extra = ("log_str",) if name.startswith("GLM") else ()
        r3 = run_path(name, 3, data, dev, kernels)
        eag = run_path(name, 3, data, dev, kernels, regions=False,
                       extra=extra)
        versus = compare_eager(f"{name} optlevel 3", r3, eag)
        r2 = run_path(name, 2, data, dev, kernels)
        a, b = r3["out"].double(), r2["out"].double()
        diff = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        # Kmeans's C_out is held by its WCSS below: its optlevels compute
        # row_norms in different orders (K4, torch's sum), and near-tie
        # rows take other centroids (kmeans_ties)
        if not diff <= 1e-3 and name != "Kmeans":
            fail(f"{name}: optlevel 3 is {diff} from optlevel 2 (bar 1e-3)")
        rec = {"diff_from_optlevel2": diff, "versus_eager": versus,
               **{k: {f: v for f, v in r.items()
                      if f not in ("out", "lines", "extra")}
                  for k, r in (("optlevel3", r3), ("eager", eag),
                               ("optlevel2", r2))}}
        check = ""
        if name == "LinearRegDS":
            rel = float(torch.linalg.norm(a - beta_true)
                        / torch.linalg.norm(beta_true))
            rec["beta_rel_err"] = rel
            check = f"|beta - beta_true| / |beta_true| = {rel:.3e} (bar 1e-3)"
            if not rel <= 1e-3:
                fail(f"LinearRegDS: beta is {rel} from beta_true")
        elif name.startswith("GLM"):
            dev_log = glm_deviances(eag["extra"]["log_str"])
            rec["deviances"] = dev_log
            rises = [(i, d0, d1) for i, (d0, d1) in
                     enumerate(zip(dev_log, dev_log[1:]), 2)
                     if d1 > d0 * (1 + 1e-6)]
            check = (f"deviance over the IRLS log {dev_log} (eager run): "
                     f"non-increasing within 1e-6 relative: {not rises}")
            if len(dev_log) != eag["iterations"] or rises:
                fail(f"{name}: deviance rises at iterations {rises}, or the "
                     f"log has {len(dev_log)} entries for "
                     f"{eag['iterations']} iterations")
        else:
            # the Lloyd iterations from the script's own first update (a
            # run with maxi 1), replayed in fp64: WCSS non-increasing, and
            # the script's last WCSS against the replay's. C_out is printed
            # beside the replay's, not held to it: on this X (Gaussian, no
            # clusters) many rows are near ties between centroids, and
            # fp32 and fp64 distances assign some of them differently
            one = run_path(name, 3, data, dev, kernels, args={"maxi": 1})
            iters = r3["iterations"]
            c_ref, wcss = kmeans_replay(x, one["out"], iters - 1)
            wcss = [_kmeans_wcss(one["lines"])] + wcss
            rises = [(i, w0, w1) for i, (w0, w1) in
                     enumerate(zip(wcss, wcss[1:]), 2) if w1 > w0 * (1 + 1e-9)]
            c_err = float(torch.linalg.norm(a - c_ref)
                          / torch.linalg.norm(c_ref))
            w_err = abs(_kmeans_wcss(r3["lines"]) - wcss[-1]) / wcss[-1]
            w2_err = abs(_kmeans_wcss(r2["lines"]) - _kmeans_wcss(
                r3["lines"])) / _kmeans_wcss(r3["lines"])
            one2 = run_path(name, 2, data, dev, kernels, args={"maxi": 1})
            ties = kmeans_ties(x, one["out"], one2["out"], iters - 1,
                               kernels)
            del one2
            rec.update({"wcss": wcss, "c_out_vs_replay": c_err,
                        "last_wcss_vs_replay": w_err,
                        "last_wcss_optlevel2_vs_3": w2_err, "ties": ties})
            check = (f"WCSS before each update {wcss} (the first the "
                     f"script's, the rest replayed in fp64 from its first "
                     f"update): non-increasing {not rises}; the script's "
                     f"last WCSS {w_err:.3e} from the replay's (bar 1e-5), "
                     f"optlevel 2's {w2_err:.3e} from optlevel 3's (bar "
                     f"1e-5); C_out {c_err:.3e} from the replay's, "
                     f"optlevel 2's {diff:.3e} from optlevel 3's (near-tie "
                     f"assignments, not held)")
            if rises or not w_err <= 1e-5 or not w2_err <= 1e-5:
                fail(f"Kmeans: WCSS rises at {rises}, or the last WCSS is "
                     f"{w_err} from the replayed iterations, or optlevel "
                     f"2's {w2_err} from optlevel 3's")
            del c_ref
        reg = r3["regions"]
        per_entry = ", ".join(
            f"{g['label']}: {g['launches'] / g['entries']:.2f} graph "
            f"launches, {g['host_syncs'] / g['entries']:.2f} host syncs per "
            f"entry" for g in reg.get("regions", []))
        unit = ("ms for the whole execution" if name in NO_LOOP
                else "ms per outer iteration")
        graph_ms = (r3["windows"]["iteration_ms"] if name in NO_LOOP
                    else versus["iteration_ms_regions"])
        print(f"[breadth] {name} ({M} x {K} fp32) optlevel 3, "
              f"{r3['iterations']} outer iterations: {unit} "
              f"{graph_ms:.3f} in the graph (with the peel and capture "
              f"{r3['windows']['iteration_ms']:.3f}) / "
              f"{eag['windows']['iteration_ms']:.3f} eager / "
              f"{r2['windows']['iteration_ms']:.3f} at optlevel 2; K2 "
              f"launches {r3['launches']['spoof_cell']} with regions, "
              f"{eag['launches']['spoof_cell']} without; K4 "
              f"{r3['launches']['spoof_row']} / {eag['launches']['spoof_row']}"
              f"; {per_entry or 'no region'}; refused "
              f"{reg.get('refused') or 'none'}; peak allocated over the data "
              f"{r3['peak_over_data'] / 1e9:.3f} GB with regions, "
              f"{eag['peak_over_data'] / 1e9:.3f} eager, "
              f"{r2['peak_over_data'] / 1e9:.3f} at optlevel 2 (X "
              f"{x.numel() * 4 / 1e9:.1f} GB); optlevel 3 vs 2 {diff:.3e}; "
              f"{check}", flush=True)
        rec["graph_ms"] = graph_ms
        out[name] = rec
        del r3, eag, r2, a, b
        torch.cuda.empty_cache()
    # where LinearRegDS's and GLM's time goes: the whole t(X) %*% X
    # (the JAX package forms it with one jnp matmul too; no hand kernel)
    tsmm_ms, = time_ms([lambda: torch.matmul(x.T, x)], reps=5, warm=1)
    flop = 2.0 * M * K * K
    out["tsmm_ms"] = tsmm_ms
    print(f"[times] t(X) %*% X ({M} x {K} fp32, TF32 off) by torch.matmul "
          f"on {nvidia_smi_line()}: {tsmm_ms:.3f} ms, "
          f"{flop / tsmm_ms / 1e9:.1f} TFLOP/s ({flop:.2e} FLOP; bound "
          f"{1e3 * flop / FP32_OPS_PER_S:.3f} ms at 67 TFLOP/s; a syrk would "
          f"compute one triangle, half the FLOP)", flush=True)
    return out


# --------------------------------------------------------------------------
# the region bridge (codegen/csrc/loop_graph.cu) on small scripts
# --------------------------------------------------------------------------

BRIDGE = {
    "zero-trip while": ("""
x = 5
i = 0
while (x < 0) {
  x = x - 1
  i = i + 1
}
""", ["x", "i"]),
    "nested while in while": ("""
outer = 0
total = matrix(0, rows=3, cols=2)
while (outer < 5) {
  inner = 0
  acc = 0.0
  while (inner < outer + 2) {
    acc = acc + inner + 1
    inner = inner + 1
  }
  total = total + acc * X
  outer = outer + 1
}
""", ["total", "outer"]),
    "if/else in while": ("""
i = 0
evens = 0
A = X
while (i < 10) {
  h = i - 2 * floor(i / 2)
  if (h == 0 & sum(A) > 0) {
    evens = evens + 1
    A = A * 1.5
  } else {
    A = A - 0.25
  }
  i = i + 1
}
""", ["evens", "A", "i"]),
    "for in while": ("""
i = 0
s = matrix(0, rows=3, cols=2)
while (i < 4) {
  for (j in 1:6) {
    s = s + j * X
  }
  i = i + 1
}
""", ["s", "j"]),
    "zero-trip inner loop": ("""
i = 0
s = 0
while (i < 4) {
  k = i
  while (k < 2) {
    s = s + 10
    k = k + 1
  }
  i = i + 1
}
""", ["s"]),
}
REENTRY = """
w = matrix(0, rows=ncol(X), cols=1)
i = 0
while (i < maxi) {
  w = w + 0.001 * (t(X) %*% (X %*% w + 1))
  i = i + 1
}
r = sum(w)
"""


def bridge_phase(dev) -> dict:
    """Each BRIDGE script through MLContext on the card (its loops one
    CUDA graph each, WHILE and IF nodes) and on the CPU (the region
    executor's plain arm), fp64 on both: the outputs equal within 1e-12
    relative; then REENTRY compiled once and run with maxi 5, 9 and 5 on
    one X: one capture, three graph launches, the first and last results
    bit-identical."""
    import numpy as np

    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.lang.parser import parse
    from systemml_tpu_torch.runtime import loopfuse
    from systemml_tpu_torch.runtime import program as P
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    x = np.arange(1.0, 7.0).reshape(3, 2) / 7.0
    out = {}
    for label, (src, outs) in BRIDGE.items():
        vals = {}
        for device in ("cuda", "cpu"):
            cfg = DMLConfig(device=device)
            cfg.floating_point_precision = "double"
            ml = MLContext(cfg)
            with PhaseTimer() as timer:
                res = ml.execute(dml(src).input("X", x).output(*outs))
            vals[device] = [np.asarray(res.get_matrix(o), dtype=np.float64)
                            if hasattr(res.get(o), "shape") and
                            res.get(o).ndim else
                            np.asarray(float(res.get_scalar(o)))
                            for o in outs]
            if device == "cuda":
                rep = loopfuse.region_report(timer.program)
        errs = [float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))
                for a, b in zip(vals["cuda"], vals["cpu"])]
        top = [r for r in rep if r.get("entries")]
        print(f"[bridge] {label}: card against the CPU's plain arm, max "
              f"relative difference {max(errs):.3e} (bar 1e-12); regions "
              f"{[(r['label'], r['trips'], r['launches'], r.get('nodes')) for r in top]}",
              flush=True)
        if not max(errs) <= 1e-12:
            fail(f"bridge {label}: card {vals['cuda']} against CPU "
                 f"{vals['cpu']}")
        if any(r.get("refused") for r in rep):
            fail(f"bridge {label}: a region was refused: {rep}")
        out[label] = {"max_rel_diff": max(errs), "regions": top}
    cfg = DMLConfig()
    cfg.floating_point_precision = "double"
    set_config(cfg)
    try:
        prog = P.compile_program(parse(REENTRY), input_names=["X", "maxi"],
                                 outputs=["r"])
        xt = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (4096, 16))).to(dev)
        rs = [prog.execute({"X": xt, "maxi": m}).vars["r"]
              for m in (5, 9, 5)]
    finally:
        set_config(DMLConfig())
    fl = [b for b in prog.blocks if isinstance(b, P.WhileBlock)][0]._fused_loop
    rec = fl.record
    print(f"[bridge] re-entry with another maxi: trips {rec['trips']}, "
          f"captures {rec['captures']}, graph launches {rec['launches']}; "
          f"r {[float(r) for r in rs]}", flush=True)
    if rec["captures"] != 1 or rec["launches"] != 3 or \
            rec["trips"] != [5, 9, 5] or not torch.equal(rs[0], rs[2]):
        fail(f"bridge re-entry: {rec}, r {rs}")
    out["re-entry"] = {k: rec[k] for k in ("trips", "captures", "launches")}
    del prog, fl
    return out


def check_set_cond(dev) -> dict:
    """set_cond (csrc/loop_graph.cu) against its plain version on a
    one-element predicate of every dtype it reads, with 0, 1, -2.5 (cast
    to the dtype) and NaN: an IF node whose body writes 1 into a flag, and
    one testing pred == 0, against pred != 0 on the host. Then its time,
    as a WHILE loop's control per iteration (k.add_(1), k < n, set_cond)
    in one graph of 20,000 iterations, against the same loop driven from
    the host (one .item() per test)."""
    from systemml_tpu_torch.codegen import loop_graph as lg
    from systemml_tpu_torch.runtime import loopfuse

    streams = loopfuse.capture_streams(dev)
    s0, s1 = streams[0], streams[1]
    flag = torch.zeros(2, dtype=torch.int32, device=dev)
    worst = 0.0
    cases = 0
    for dtype in (torch.bool, torch.float32, torch.float64, torch.int64,
                  torch.int32):
        values = (0, 1, -2.5, float("nan")) if dtype.is_floating_point \
            else ((0, 1) if dtype == torch.bool else (0, 1, -2))
        for v in values:
            pred = torch.full((), v, dtype=dtype, device=dev)
            pool = torch.cuda.MemPool()
            s0.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s0), torch.cuda.use_mem_pool(pool, dev):
                lg.capture_begin(s0.cuda_stream)
                for slot, neg in ((0, False), (1, True)):
                    h = lg.begin_node(s0.cuda_stream, s1.cuda_stream, lg.IF,
                                      pred, negate=neg)
                    with torch.cuda.stream(s1):
                        flag[slot].fill_(1)
                        lg.end_node(s1.cuda_stream, lg.IF, h)
                graph = lg.capture_end(s0.cuda_stream)
            ex = lg.instantiate(graph)
            flag.zero_()
            lg.launch(ex, torch.cuda.current_stream(dev).cuda_stream)
            got = flag.tolist()
            want = lg.set_cond_plain(pred)
            worst = max(worst, abs(got[0] - int(want)),
                        abs(got[1] - int(not want)))
            cases += 1
            lg.destroy(graph, ex)
            del pool
    n = 20_000
    k = torch.zeros((), dtype=torch.int64, device=dev)
    pool = torch.cuda.MemPool()
    s0.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s0), torch.cuda.use_mem_pool(pool, dev):
        lg.capture_begin(s0.cuda_stream)
        h = lg.begin_node(s0.cuda_stream, s1.cuda_stream, lg.WHILE, k < n)
        with torch.cuda.stream(s1):
            k.add_(1)
            lg.end_node(s1.cuda_stream, lg.WHILE, h, k < n)
        graph = lg.capture_end(s0.cuda_stream)
    ex = lg.instantiate(graph)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = []
    for _ in range(3):
        k.zero_()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        lg.launch(ex, stream)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    if int(k) != n:
        fail(f"set_cond: the WHILE loop ran {int(k)} times, not {n}")
    lg.destroy(graph, ex)
    del pool
    m = 2_000
    k.zero_()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    while bool((k < m).item()):
        k.add_(1)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1) / m
    ms = sorted(times)[1]
    print(f"[kernel] set_cond: {cases} predicates of 5 dtypes, IF and its "
          f"negation against pred != 0 on the host: max abs error {worst} "
          f"(bar 0); a WHILE loop's control per iteration {ms * 1e3:.2f} us "
          f"in one graph ({[round(t * 1e3, 2) for t in times]}), driven "
          f"from the host {plain_ms * 1e3:.2f} us", flush=True)
    if worst != 0:
        fail("set_cond disagrees with its plain version")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def templates_of(prog) -> list:
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    return [(h.params["template"], h.params.get("agg")
             or h.params.get("row_agg"), h.params["plan"].pretty())
            for h in iter_spoof_hops(prog)]


# --------------------------------------------------------------------------
# spoof kernels against their plain versions
# --------------------------------------------------------------------------

def _n(CNode, op, *kids):
    return CNode(op, list(kids))


def kmeans_row_hop(prog):
    """The row plan that the block compile selects for Kmeans.dml's
    `row_norms = rowSums(X ^ 2)` at X's run-time dims (M, K), as its
    optlevel-3 run selects it (runtime/blockcompile.select)."""
    import copy

    from systemml_tpu_torch.runtime import blockcompile
    from systemml_tpu_torch.runtime.program import iter_basic_blocks
    from systemml_tpu_torch.utils.config import get_config, set_config

    blocks = [b for b in iter_basic_blocks(prog)
              if b.top_level and "row_norms" in b.hops.writes]
    old = get_config()
    set_config(config(3))
    try:
        new = blockcompile.select(copy.deepcopy(blocks[0].hops),
                                  {"X": (M, K)}) if len(blocks) == 1 else []
    finally:
        set_config(old)
    if [(h.params["template"], h.params["plan"].pretty()) for h in new] \
            != [("row", KMEANS_ROW_PLAN)]:
        fail(f"Kmeans's row_norms block: {len(blocks)} blocks, block "
             f"compile plans {[h.params['plan'].pretty() for h in new]}, "
             f"not the one row plan {KMEANS_ROW_PLAN}")
    return new[0]


def kernel_plans(progs):
    """(label, template, plan, leaf names) of the kernel phase: the
    paths' own plans (l2-svm's 10-leaf cell plan, MultiLogReg's row plan,
    last minibatch-sgd's row plan, Kmeans's row plan of the block
    compile) and three made here."""
    from systemml_tpu_torch.codegen.cplan import CELL_BINARY, CELL_UNARY, CNode
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    cells = [h for h in iter_spoof_hops(progs["l2-svm"])
             if h.params["template"] == "cell"]
    svm = max(cells, key=lambda h: len(h.params["leaf_names"]))
    rows = [h for h in iter_spoof_hops(progs["MultiLogReg"])
            if h.params["template"] == "row"]
    if len(svm.params["leaf_names"]) != 10 or not rows:
        fail("l2-svm has no 10-leaf cell plan or MultiLogReg no row plan: "
             f"{templates_of(progs['l2-svm'])}, "
             f"{templates_of(progs['MultiLogReg'])}")
    row = rows[0]
    if row.params["plan"].pretty() != "u(exp)(b(-)(i0, i1))":
        fail(f"MultiLogReg's row plan is {row.params['plan'].pretty()}")
    sgd = list(iter_spoof_hops(progs["minibatch-sgd"]))
    if [h.params["plan"].pretty() for h in sgd] != [MINIBATCH_ROW_PLAN]:
        fail(f"minibatch-sgd's plans are "
             f"{templates_of(progs['minibatch-sgd'])}, not the one row "
             f"plan {MINIBATCH_ROW_PLAN}")
    km = kmeans_row_hop(progs["Kmeans"])
    i = lambda nm: CNode("in", name=nm)
    lit = lambda v: CNode("lit", value=v)
    n = lambda op, *kids: _n(CNode, op, *kids)
    # every layout: i0 (m, n), i1 (1, n), i2 (m, 1), i3 (1, 1), s a host
    # number, t a 0-d tensor
    ragged = n("b(+)", n("b(*)", n("b(min)", i("i0"), i("i1")),
                         n("b(-)", i("s"), i("i2"))),
               n("b(+)", n("b(^)", n("b(max)", i("i0"), i("t")), lit(2.0)),
                 n("b(*)", n("u(sigmoid)", i("i3")),
                   n("b(>)", i("i0"), n("u(abs)", i("i2"))))))
    # every op once: a sum of small terms
    e = i("i0")
    for op in sorted(CELL_UNARY):
        arg = n("b(*)", lit(0.5), i("i0"))
        if op in ("u(log)", "u(sqrt)"):
            arg = n("u(abs)", arg)
        e = n("b(+)", e, n("b(*)", lit(1e-3), n(op, arg)))
    for op in sorted(CELL_BINARY):
        rhs = lit(2.0) if op == "b(^)" else i("i1")
        e = n("b(+)", e, n("b(*)", lit(1e-3), n(op, i("i0"), rhs)))
    every = n("b(+)", e, n("b(^)", n("u(abs)", i("i2")), i("i3")))
    # the values every op is checked at: NaN into min and max, 0 into
    # sign, x.5 into round
    special = n("b(+)", n("b(+)", n("b(min)", i("i0"), i("i1")),
                          n("b(max)", i("i2"), i("i0"))),
                n("b(+)", n("u(round)", i("i0")), n("u(sign)", i("i2"))))
    return [("l2-svm cell", "cell", svm.params["plan"],
             list(svm.params["leaf_names"]), svm),
            ("MultiLogReg row", "row", row.params["plan"],
             list(row.params["leaf_names"]), row),
            ("ragged", None, ragged, ["i0", "i1", "s", "i2", "t", "i3"], None),
            ("every op", None, every, ["i0", "i1", "i2", "i3"], None),
            ("specials", None, special, ["i0", "i1", "i2"], None),
            ("minibatch-sgd row", "row", sgd[0].params["plan"],
             list(sgd[0].params["leaf_names"]), sgd[0]),
            ("Kmeans row", "row", km.params["plan"],
             list(km.params["leaf_names"]), km)]


def kernel_env(label, hop, names, dtype, dev, gen):
    """Leaf values of a kernel-phase plan, made on the card."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev,
                                   dtype=dtype)
    if label == "l2-svm cell":
        # the leaves are the line search's Y, Xw, step_sz and Xd
        by_name = {"Y": torch.sign(r(M, 1)), "Xw": r(M, 1), "Xd": r(M, 1),
                   "step_sz": torch.tensor(0.05, device=dev)}
        env = {}
        for nm, h in zip(names, hop.inputs):
            if h.op != "tread" or h.name not in by_name:
                fail(f"l2-svm's plan reads {h.op} {h.name!r}")
            env[nm] = by_name[h.name]
        return env
    if label == "MultiLogReg row":
        z = r(M, 5)
        return {"i0": z, "i1": z.amax(dim=1, keepdim=True)}
    if label == "minibatch-sgd row":
        # dscores' row sum at a batch of 1,000: Y_batch, the scores'
        # product and bias, their row max, the exponentials' row sum
        bs = PATHS["minibatch-sgd"][2]["bs"]
        y = torch.nn.functional.one_hot(torch.randint(
            0, 5, (bs,), generator=gen, device=dev), 5).to(dtype)
        xw, bias = r(bs, 5), r(1, 5)
        mx = (xw + bias).amax(dim=1, keepdim=True)
        se = torch.exp(xw + bias - mx).sum(dim=1, keepdim=True)
        return {"i0": y, "i1": xw, "i2": bias, "i3": mx, "i4": se,
                "i5": xw, "i6": bias, "i7": mx, "i8": se}
    if label == "Kmeans row":
        # row_norms = rowSums(X ^ 2) over the path's X shape
        return {names[0]: r(M, K)}
    if label == "ragged":
        m, n = 100_003, 7
        return {"i0": r(m, n), "i1": r(1, n), "i2": r(m, 1), "i3": r(1, 1),
                "s": 0.25,
                "t": torch.tensor(-0.5, device=dev, dtype=torch.float64)}
    if label == "every op":
        m, n = 100_003, 7
        mag = lambda *shape: 0.5 + torch.rand(*shape, generator=gen,
                                              device=dev, dtype=dtype)
        return {"i0": torch.sign(r(m, n)) * mag(m, n),
                "i1": torch.sign(r(1, n)) * mag(1, n), "i2": mag(m, 1),
                "i3": torch.full((1, 1), 1.7, device=dev, dtype=dtype)}
    m, n = 100_003, 7
    i0 = torch.randint(-4, 4, (m, n), generator=gen, device=dev).to(dtype) + 0.5
    i0[::5, 1] = float("nan")
    i1 = r(1, n)
    i1[0, 2] = float("nan")
    i2 = torch.randint(-1, 2, (m, 1), generator=gen, device=dev).to(dtype)
    i2[3, 0] = float("nan")
    return {"i0": i0, "i1": i1, "i2": i2}


def kernel_phase_sources(progs, als_progs, dev, kernels) -> list:
    """(template, plan, Variant) of the sources that the kernel and time
    phases launch beyond the paths' own, each Variant derived from the
    values the plan is called with, as the wrappers derive it
    (kernels.env_variant): the kernel phase's plans through the cell and
    row templates and, but "every op", through every aggregate order of
    AGG_ORDERS; the summary's plan through every order and elementwise."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}

    def add(template, plan, env, aggs=()):
        v = kernels.env_variant(template, plan.input_names(), env, aggs)
        out[(template, plan.key(), v)] = (template, plan, v)

    for label, template, plan, names, hop in kernel_plans(progs):
        env = kernel_env(label, hop, names, torch.float32, dev, gen)
        for t in ((template,) if template else ("cell", "row")):
            add(t, plan, env)
        if template is None and label != "every op":
            for aggs in AGG_ORDERS:
                add("multiagg", plan, env, aggs)
        del env
    summ = _plan_of(als_progs["summary"], "multiagg")
    plan, names = summ.params["plan"], list(summ.params["leaf_names"])
    v = torch.ones(8, 8, device=dev)
    env = {names[0]: v, names[1]: v, names[2]: v.sum(), names[3]: v.sum()}
    for aggs in AGG_ORDERS:
        add("multiagg", plan, env, aggs)
    add("cell", plan, env)
    return list(out.values())


def walk_line(events) -> str:
    """The launches of the cell and multi-aggregate templates by walk."""
    return (f"walks flat {events.get('spoof_flat_walk', 0)} general "
            f"{events.get('spoof_general_walk', 0)}")


def check_walks(label, events, launches) -> None:
    """Every cell and multi-aggregate launch counted on one walk."""
    walked = (events.get("spoof_flat_walk", 0)
              + events.get("spoof_general_walk", 0))
    if walked != launches["spoof_cell"] + launches["spoof_multiagg"]:
        fail(f"{label}: {walked} launches counted by walk, "
             f"{launches['spoof_cell'] + launches['spoof_multiagg']} "
             f"launched")


class SpoofSpy:
    """For the duration of a with-block, counts the cell-template sums
    that the program runs by plan and main-leaf shape and keeps the last
    call of each (plan, leaf names, env, Variant): the time phase times
    the most launched at the path's own inputs."""

    def __enter__(self):
        from systemml_tpu_torch.codegen import compiler, kernels
        self._compiler = compiler
        self._orig = compiler.execute_spoof
        self.counts, self.last = {}, {}

        def spy(h, args):
            if h.params["template"] == "cell" and h.params.get("agg") == "sum":
                names = list(h.params["leaf_names"])
                env = dict(zip(names, args))
                mats = kernels._matrices(names, env)
                key = (h.params["plan"].key(),
                       tuple(env[mats[0]].shape) if mats else None)
                self.counts[key] = self.counts.get(key, 0) + 1
                self.last[key] = (h.params["plan"], names, env,
                                  compiler.hop_variant(h))
            return self._orig(h, args)

        compiler.execute_spoof = spy
        return self

    def __exit__(self, *exc):
        self._compiler.execute_spoof = self._orig

    def most_launched(self):
        """(launches, last call) of the plan and main-leaf shape launched
        most; of equals, the first launched."""
        key = max(self.counts, key=self.counts.get)
        return self.counts[key], self.last[key]



def check_spoof_kernels(progs, dev, kernels) -> dict:
    """Every kernel-phase plan through the cell kernel (elementwise and
    sum) and the row kernel (sum, min, max), in fp32 and fp64, twice,
    against the plain version in fp64 from the same inputs. Returns the
    max abs errors at the paths' own plans in fp32."""
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {"spoof_cell": 0.0, "spoof_row": 0.0}
    for label, template, plan, names, hop in kernel_plans(progs):
        arms = ([("cell", None), ("cell", "sum")] if template == "cell" else
                [("row", "sum"), ("row", "min"), ("row", "max")]
                if template == "row" else
                [("cell", None), ("cell", "sum"), ("row", "sum"),
                 ("row", "min"), ("row", "max")])
        for dtype in (torch.float32, torch.float64):
            env = kernel_env(label, hop, names, dtype, dev, gen)
            envd = {k: (v.double() if isinstance(v, torch.Tensor) else v)
                    for k, v in env.items()}
            for tmpl, agg in arms:
                wrap = kernels.cell_kernel if tmpl == "cell" else \
                    kernels.row_kernel
                plain = kernels.cell_plain if tmpl == "cell" else \
                    kernels.row_plain
                before = wrap.launches
                out = wrap(plan, names, agg, env)
                again = wrap(plan, names, agg, env)
                ref = plain(plan, names, agg, envd)
                torch.cuda.synchronize()
                nan_ok = bool(torch.equal(out.isnan(), ref.isnan()))
                same = bool(torch.equal(out.nan_to_num(0.0),
                                        again.nan_to_num(0.0)))
                ok = ~ref.isnan()
                diff = out.double()[ok] - ref[ok]
                den = float(torch.linalg.norm(ref[ok]))
                err = float(torch.linalg.norm(diff)) / den if den else \
                    float(torch.linalg.norm(diff))
                abs_err = float(diff.abs().max()) if diff.numel() else 0.0
                shape = tuple(env[names[0]].shape) if label != "l2-svm cell" \
                    else (M, 1)
                print(f"[kernel] spoof {tmpl} {agg or 'elementwise'} "
                      f"{label} {shape} {str(dtype)[6:]}: normwise "
                      f"{err:.3e} (bar {SPOOF_BARS[dtype]:g}), max abs "
                      f"{abs_err:.3e}, NaN at the same places {nan_ok}, "
                      f"repeat bit-identical {same}", flush=True)
                if wrap.launches != before + 2:
                    fail(f"spoof {tmpl} {label}: the kernel did not launch")
                if not (err <= SPOOF_BARS[dtype]) or not nan_ok or not same:
                    fail(f"spoof {tmpl} {agg} {label} {dtype}: normwise "
                         f"{err}, NaN places equal {nan_ok}, repeat "
                         f"identical {same}")
                if dtype == torch.float32 and template is not None:
                    key = "spoof_cell" if tmpl == "cell" else "spoof_row"
                    errs[key] = max(errs[key], abs_err)
            del env, envd
    torch.cuda.empty_cache()
    return errs


def plan_ops(plan) -> int:
    """Operations per element of a plan: its op nodes."""
    if plan.op in ("in", "lit"):
        return 0
    return 1 + sum(plan_ops(c) for c in plan.inputs)


def spoof_bound(plan, env, out_bytes, cells):
    """(bound ms, bound_by): the distinct leaf tensors read once and the
    output written once over 3.35 TB/s, against the plan's operations
    per element over 67 TFLOP/s."""
    seen = {}
    for v in env.values():
        if isinstance(v, torch.Tensor):
            seen[v.data_ptr()] = v.numel() * v.element_size()
    bytes_ms = 1e3 * (sum(seen.values()) + out_bytes) / HBM_BYTES_PER_S
    ops_ms = 1e3 * plan_ops(plan) * cells / FP32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


# --------------------------------------------------------------------------
# compressed LA: K6 against its plain version, and the LinearRegCG-cla path
# --------------------------------------------------------------------------

def make_census(dev):
    """The categorical X (CENSUS_N, CENSUS_M) fp32 and the scripts'
    targets, from one seeded generator on the card. Column j takes d_j
    values, d_j in 2..8, with uniform codes; its dictionary is drawn
    N(0, 1) and standardised (mean 0, variance 1 under uniform codes):
    with the raw draws, the columns' shared nonzero means and the
    near-constant columns leave t(X) X ill-conditioned, and 20 CG
    iterations stop far from the solution in either cla mode."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n, m = CENSUS_N, CENSUS_M
    x = torch.empty(n, m, device=dev)
    # the codes themselves, 0-based (the parfor and transform phases)
    codes = torch.empty(n, m, dtype=torch.uint8, device=dev)
    dims = torch.randint(2, 9, (m,), generator=gen, device=dev).tolist()
    for j, d in enumerate(dims):
        dct = torch.randn(d, generator=gen, device=dev)
        dct = (dct - dct.mean()) / dct.std(correction=0)
        idx = torch.randint(0, d, (n,), generator=gen, device=dev)
        codes[:, j] = idx.to(torch.uint8)
        x[:, j] = dct[idx]
    beta_true = torch.randn(m, 1, generator=gen, device=dev)
    y = x @ beta_true + 0.01 * torch.randn(n, 1, generator=gen, device=dev)
    w_svm = torch.randn(m, 1, generator=gen, device=dev)
    z = x @ w_svm + 0.1 * torch.randn(n, 1, generator=gen, device=dev)
    return {"X": x, "y": y, "beta_true": beta_true,
            "Y_svm": torch.where(z >= 0, 1.0, -1.0), "dims": dims,
            "codes": codes}


def chain_codes(dev, gen, n, groups, dmax):
    """(groups, n) uint8 codes in K6's layout; group 0 takes dmax values,
    the others 1..dmax."""
    from systemml_tpu_torch.compress import device as cla_dev

    ds = [dmax] + torch.randint(1, dmax + 1, (groups - 1,), generator=gen,
                                device=dev).tolist()
    return cla_dev.chain_codes(torch.stack(
        [torch.randint(0, d, (n,), generator=gen, device=dev)
         .to(torch.uint8) for d in ds]))


def _chain_case(label, codes, sv, w, ctype) -> None:
    """K6 twice against chain_plain in fp64 on the card: NaN and +-Inf in
    the same slots, the finite slots within the bar, repeats bit-identical
    (NaN compared by place)."""
    from systemml_tpu_torch.compress import device as cla_dev

    before = cla_dev.chain_kernel.launches
    out = cla_dev.chain_kernel(codes, sv, w, ctype)
    again = cla_dev.chain_kernel(codes, sv, w, ctype)
    ref = cla_dev.chain_plain(codes, sv.double(),
                              None if w is None else w.double(), ctype)
    torch.cuda.synchronize()
    places = all(bool(torch.equal(f(out), f(ref))) for f in
                 (torch.isnan, torch.isposinf, torch.isneginf))
    fin = torch.isfinite(ref)
    err = normwise(out[fin], ref[fin])
    # per slot: the worst relative error of the slots with |value| at
    # least 1e-3 of the largest (no slot's own rounding bound here; the
    # card test test_cla_chain_heavy_tailed_z holds each slot to its own)
    big = fin & (ref.abs() >= 1e-3 * ref[fin].abs().max())
    slot = float(((out[big] - ref[big]).abs() / ref[big].abs()).max()) \
        if bool(big.any()) else 0.0
    same = bool(torch.equal(out.nan_to_num(), again.nan_to_num())
                and torch.equal(out.isnan(), again.isnan()))
    bar = CHAIN_BARS[sv.dtype]
    print(f"[kernel] cla_chain {label}: {int(torch.isnan(ref).sum())} NaN "
          f"and {int(torch.isinf(ref).sum())} +-Inf slots of "
          f"{ref.numel()} in the plain version, same places {places}; "
          f"finite slots normwise {err:.3e} (bar {bar:g}), worst per slot "
          f"{slot:.3e} relative over the {int(big.sum())} slots of at least "
          f"1e-3 of the largest; repeat bit-identical {same}", flush=True)
    if cla_dev.chain_kernel.launches != before + 2:
        fail(f"cla_chain {label}: the kernel did not launch")
    if not (places and err <= bar and same):
        fail(f"cla_chain {label}: NaN/Inf places {places}, normwise {err}, "
             f"repeat identical {same}")


def check_chain_special(codes, dev, gen) -> None:
    """At the Census shape, fp32, k = 1: NaN, +Inf and -Inf rows in w and
    in y (a tile with one takes the kernel's fp64 branch), and every row
    of each group on one code (the integer atomics' worst case)."""
    from systemml_tpu_torch.compress import device as cla_dev

    groups, n = codes.shape
    sv = torch.randn(8, groups, 1, generator=gen, device=dev)
    w = torch.randn(n, 1, generator=gen, device=dev)
    for r, v in ((5, "nan"), (70_000, "inf"), (1_000_000, "inf"),
                 (1_000_001, "-inf"), (n - 1, "-inf")):
        w[r, 0] = float(v)
    for ctype in ("XtwXv", "XtXvy"):
        _chain_case(f"{ctype} codes ({groups}, {n}) fp32 k=1 with NaN, "
                    f"+Inf and -Inf rows in w/y", codes, sv, w, ctype)
    one = cla_dev.chain_codes(torch.full((groups, n), 3, dtype=torch.uint8,
                                         device=dev))
    _chain_case(f"XtXv codes ({groups}, {n}) fp32 k=1, every row on code 3",
                one, sv, None, "XtXv")
    # heavy-tailed z: w log-uniform over 12 decades, so each tile's scale
    # drops the low bits of its small z
    w = torch.exp(torch.empty(n, 1, device=dev).uniform_(
        -6 * math.log(10), 6 * math.log(10), generator=gen)) * torch.where(
        torch.rand(n, 1, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    _chain_case(f"XtwXv codes ({groups}, {n}) fp32 k=1, w log-uniform "
                f"over 12 decades", codes, sv, w, "XtwXv")


def check_chain_kernel(dev) -> float:
    """K6 against chain_plain in fp64 on the card, twice; then two blocks
    that K6 refuses by layout through the compressed mmchain. Returns the
    max abs error at the path's shape in fp32, k = 1, XtXv."""
    import numpy as np

    from systemml_tpu_torch.compress import compress
    from systemml_tpu_torch.compress import device as cla_dev
    from systemml_tpu_torch.ops import mult
    from systemml_tpu_torch.utils import stats

    gen = torch.Generator(device=dev).manual_seed(4)
    abs_err = None
    for n, groups, dmax in ((CENSUS_N, CENSUS_M, 8), (100_003, 7, 5)):
        codes = chain_codes(dev, gen, n, groups, dmax)
        for dtype in (torch.float32, torch.float64):
            for k in (1, 4):
                sv = torch.randn(dmax, groups, k, generator=gen, device=dev,
                                 dtype=dtype)
                for ctype, wc in (("XtXv", 0), ("XtwXv", 1), ("XtXvy", k)):
                    w = (torch.randn(n, wc, generator=gen, device=dev,
                                     dtype=dtype) if wc else None)
                    before = cla_dev.chain_kernel.launches
                    out = cla_dev.chain_kernel(codes, sv, w, ctype)
                    again = cla_dev.chain_kernel(codes, sv, w, ctype)
                    ref = cla_dev.chain_plain(
                        codes, sv.double(),
                        None if w is None else w.double(), ctype)
                    torch.cuda.synchronize()
                    err = normwise(out, ref)
                    err_abs = float((out - ref).abs().max())
                    same = bool(torch.equal(out, again))
                    print(f"[kernel] cla_chain {ctype} codes ({groups}, {n}) "
                          f"dmax {dmax} k={k} w=({n},{wc}) "
                          f"{str(dtype)[6:]}: normwise {err:.3e} (bar "
                          f"{CHAIN_BARS[dtype]:g}), max abs {err_abs:.3e}, "
                          f"repeat bit-identical {same}", flush=True)
                    if cla_dev.chain_kernel.launches != before + 2:
                        fail("cla_chain: the kernel did not launch")
                    if not err <= CHAIN_BARS[dtype] or not same:
                        fail(f"cla_chain {ctype} ({groups}, {n}) k={k} "
                             f"{dtype}: normwise {err}, repeat identical "
                             f"{same}")
                    if (n, dtype, k, ctype) == (CENSUS_N, torch.float32, 1,
                                                "XtXv"):
                        abs_err = err_abs
        if n == CENSUS_N:
            check_chain_special(codes, dev, gen)
        del codes
    # blocks that K6 refuses by layout take the gather arm, counted
    rng = np.random.default_rng(5)
    n = 100_003
    base = [rng.standard_normal(d)[rng.integers(0, d, n)] for d in (2, 5, 8)]
    for label, extra in (
            ("a dictionary of 9", rng.standard_normal(9)[
                rng.integers(0, 9, n)]),
            ("an uncompressed column", rng.standard_normal(n))):
        xh = np.column_stack(base + [extra]).astype(np.float32)
        c = compress(xh)
        v = torch.randn(4, 1, generator=gen, device=dev)
        st = stats.Statistics()
        before = cla_dev.chain_kernel.launches
        with stats.stats_scope(st):
            out = mult.mmchain(c, v)
        xd = torch.from_numpy(xh).to(dev).double()
        err = normwise(out, xd.T @ (xd @ v.double()))
        by_layout = st.estim_counts.get("cla_chain_plain_by_layout", 0)
        print(f"[kernel] cla_chain refused by layout, {label} ({n} x 4): "
              f"cla_chain_plain_by_layout {by_layout}, K6 launches "
              f"{cla_dev.chain_kernel.launches - before}, gather arm "
              f"normwise {err:.3e}", flush=True)
        if by_layout != 1 or cla_dev.chain_kernel.launches != before \
                or not err <= 1e-5:
            fail(f"the compressed mmchain on a block with {label} did not "
                 f"take the gather arm by layout")
    torch.cuda.empty_cache()
    return abs_err


def run_cla_path(name, cla, data, dev, kernels, regions: bool = True):
    """One unprofiled run at optlevel 2 with `cla` on the categorical X,
    after a warm-up on its first 200,000 rows (which compresses too, so
    that the compressed ops' first calls, their allocations and cuBLAS's
    choices for the table's shape, are not in the timed loop); the launch
    counters are set to 0 just before it and read just after. `regions`
    False runs it with codegen_enabled False; then LinearRegCG-cla runs
    once more under torch.profiler (its loop's busy share)."""
    from systemml_tpu_torch.api.mlcontext import MLContext

    cfg = config(2, regions)
    cfg.cla = cla
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    ml.execute(path_script(name, data, rows=200_000))
    lines = []
    ml.printer = lines.append
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)   # the data of every path
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        out = ml.execute(path_script(name, data)).get_tensor(PATHS[name][3])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    iters = outer_iterations(name, lines)
    events = {k: v for k, v in ml._stats.estim_counts.items()
              if k.startswith(("cla_", "kb_pick_cla_"))}
    tag = f"{name}-cla cla={cla}" + ("" if regions else " eager")
    windows = phase_windows(timer, iters, tag, PATHS[name][5])
    reg = region_report(timer, tag, "LinearRegCG-cla" if (name, cla) == (
        "LinearRegCG", "auto") else name, regions)
    comp_s = sum(w[0] for w in timer.windows["compress"]) / 1e3
    layout_ms = windows["compress_host_ms"] - 1e3 * comp_s
    windows["compression_s"] = comp_s
    for s in lines[-1:]:
        print(f"[script] {s}")
    print(f"[cla] {tag} on ({CENSUS_N}, {CENSUS_M}) fp32: {iters} "
          f"outer iterations, {windows['iteration_ms']:.3f} ms per outer "
          f"iteration (device window; host "
          f"{windows['iteration_host_ms']:.3f} ms), loop-entry compression "
          f"{comp_s:.3f} s, device layouts in the loop {layout_ms:.3f} ms; "
          f"{secs:.3f} s in all; "
          f"launches {launches}; {events}; peak allocated "
          f"{peak / 1e9:.3f} GB, {(peak - base) / 1e9:.3f} GB over the "
          f"data allocated before the run (X "
          f"{CENSUS_N * CENSUS_M * 4 / 1e9:.3f} GB among it)", flush=True)
    if out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        fail(f"{name} cla={cla}: output {out.dtype} not finite fp32")
    compressed = events.get("cla_auto_compressed", 0)
    if compressed != (1 if cla == "auto" else 0):
        fail(f"{name} cla={cla}: cla_auto_compressed {compressed}")
    if events.get("cla_chain_plain_by_layout", 0):
        fail(f"{name} cla={cla}: the compressed mmchain took the gather arm "
             f"by layout")
    chain = iters if (name == "LinearRegCG" and cla == "auto") else 0
    if launches["cla_chain"] != chain or iters < 1:
        fail(f"{name} cla={cla}: K6 launched {launches['cla_chain']} times "
             f"in {iters} outer iterations")
    st = ml._stats
    # getattr: --bench runs this file in an earlier tree too, whose
    # Statistics have no block compile
    blocks = {"fused": getattr(st, "fused_blocks", 0),
              "eager": st.eager_blocks,
              "plans": getattr(st, "compile_count", 0),
              "eager_by_reason": dict(getattr(st, "eager_reasons", {})),
              "graphs": dict(getattr(st, "block_graph_counts", {})),
              "block_spoof_plans": events.get("block_spoof_plans", 0)}
    result = {"out": out, "iterations": iters, "seconds": secs,
              "exec_seconds": ml._stats.run_time, "launches": launches,
              "blocks": blocks,
              "peak_bytes": peak, "peak_reserved": peak_reserved,
              "peak_over_data_bytes": peak - base, "lines": lines,
              "windows": windows, "events": events, "regions": reg,
              "compressed": timer.compressed}
    if name == "LinearRegCG" and cla == "auto" and not regions:
        # the CG loop's period and busy share, from K6's launches (one
        # cla_chain_reduce each)
        result["profile"] = profile_main_path(
            ml, path_script(name, data), False, kernel="cla_chain_reduce")
    return result


def cla_paths(dev, kernels) -> dict:
    """LinearRegCG-cla and l2-svm on the categorical X, each with cla
    "auto" and "false"; the outputs agree within 1e-3, and beta is within
    1e-3 of beta_true."""
    data = make_census(dev)
    print(f"[cla] categorical X ({CENSUS_N}, {CENSUS_M}) fp32, "
          f"{CENSUS_N * CENSUS_M * 4 / 1e9:.3f} GB dense; values per "
          f"column {data['dims']}", flush=True)
    out = {"data": data}
    for name in ("LinearRegCG", "l2-svm"):
        runs = {cla: run_cla_path(name, cla, data, dev, kernels)
                for cla in ("auto", "false")}
        if name == "LinearRegCG":
            # the CG loop as one graph against its eager run (K6's
            # launches equal, the busy share), and a repeat, bit for bit
            runs["auto-eager"] = run_cla_path(name, "auto", data, dev,
                                              kernels, regions=False)
            runs["auto-repeat"] = run_cla_path(name, "auto", data, dev,
                                               kernels)
            runs["auto"]["versus_eager"] = compare_eager(
                "LinearRegCG-cla", runs["auto"], runs["auto-eager"])
            same = bool(torch.equal(runs["auto"]["out"],
                                    runs["auto-repeat"]["out"]))
            print(f"[cla] LinearRegCG-cla: a repeat of the region run "
                  f"bit-identical {same}", flush=True)
            if not same:
                fail("LinearRegCG-cla: two runs of the region differ")
            runs["auto"]["repeat_bit_identical"] = same
        a, b = runs["auto"]["out"].double(), runs["false"]["out"].double()
        diff = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        print(f"[cla] {name}: |cla auto - cla false| / |cla false| = "
              f"{diff:.3e} (bar 1e-3); ms per outer iteration "
              f"{runs['auto']['windows']['iteration_ms']:.3f} / "
              f"{runs['false']['windows']['iteration_ms']:.3f}", flush=True)
        if not diff <= 1e-3:
            fail(f"{name}: cla auto is {diff} from cla false")
        if name == "LinearRegCG":
            bt = data["beta_true"].double()
            rel = float(torch.linalg.norm(a - bt) / torch.linalg.norm(bt))
            print(f"[cla] LinearRegCG-cla: |beta - beta_true| / "
                  f"|beta_true| = {rel:.3e} (bar 1e-3)", flush=True)
            if not rel <= 1e-3:
                fail(f"LinearRegCG-cla: beta is {rel} from beta_true")
            runs["auto"]["beta_true_rel_err"] = rel
        runs["auto"]["diff_from_cla_false"] = diff
        out[name] = runs
    return out


def time_chain_kernel(cla, dev, smi, max_abs_err) -> dict:
    """K6 at the path's own compressed X (the block LinearRegCG-cla bound
    at its loop entry), k = 1, fp32: the kernel, its plain version, the
    whole compressed chain around it (table, kernel, output assembly), the
    gather arm, and the two-pass torch.matmul on the dense X. Returns the
    kernel's record."""
    from systemml_tpu_torch.compress import device as cla_dev

    c = cla["LinearRegCG"]["auto"]["compressed"][0]
    lay = cla_dev.chain_layout(c)
    gen = torch.Generator(device=dev).manual_seed(6)
    v = torch.randn(CENSUS_M, 1, generator=gen, device=dev)
    sv = cla_dev.chain_table(lay, v)
    xc = cla["data"]["X"]
    one = cla_dev.chain_codes(torch.full_like(lay.codes, 3))
    kern = lambda: cla_dev.chain_kernel(lay.codes, sv)
    # 50 calls a reading, as the bench: the host launches a call in a
    # third of the kernel's time, so only the first call's launch is idle
    events_ms, one_events_ms = time_ms(
        [kern, lambda: cla_dev.chain_kernel(one, sv)], reps=50)
    plain_ms, call_ms, gather_ms, dense_ms = time_ms([
        lambda: cla_dev.chain_plain(lay.codes, sv),
        lambda: cla_dev.chain_mmchain(c, v),
        lambda: cla_dev.gather_mmchain(c, v, None, "XtXv"),
        lambda: torch.matmul(xc.T, torch.matmul(xc, v)),
    ], reps=10)
    # beside the events, the card's time per call alone (torch.profiler)
    kern_ms = device_ms(kern)
    one_ms = device_ms(lambda: cla_dev.chain_kernel(one, sv))
    call_dev_ms = device_ms(lambda: cla_dev.chain_mmchain(c, v))
    wrapper_us = host_us({"k6": kern}, reps=100, rounds=4)[0]["k6"]
    k = 1
    nbytes = (lay.codes.numel() + sv.numel() * sv.element_size()
              + 8 * lay.dmax * lay.groups * k)   # codes, table in; out
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2.0 * lay.groups * lay.n * k / FP32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[times] cla_chain XtXv codes ({lay.groups}, {lay.n}) dmax "
          f"{lay.dmax} k=1 fp32 on {smi}: kernel {events_ms:.4f} ms by CUDA "
          f"events over back-to-back calls, {kern_ms:.4f} ms device time "
          f"per call (torch.profiler), the wrapper's host time "
          f"{wrapper_us:.1f} us a call; every row on one code "
          f"{one_events_ms:.4f} ms ({one_ms:.4f} device time); plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
          f"{bytes_ms:.4f}, operations {ops_ms:.4f}); the whole compressed "
          f"chain (table, kernel, assembly) {call_ms:.4f} ms by events, "
          f"{call_dev_ms:.4f} ms device time, the gather "
          f"arm {gather_ms:.4f} ms; yardstick, the two-pass torch.matmul "
          f"on the dense X ({xc.numel() * 4 / 1e9:.3f} GB) {dense_ms:.4f} "
          f"ms (no single torch call computes a compressed chain)",
          flush=True)
    return {"name": "cla_chain", "route": "cuda",
            "source": "systemml_tpu_torch/codegen/csrc/cla_chain.cu",
            "replaces": "systemml_tpu/compress/device.py:525 "
                        "_chain_kernel_call",
            "launches": cla["LinearRegCG"]["auto"]["launches"]["cla_chain"],
            "max_abs_err": max_abs_err["cla_chain"], "ms": events_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "device_ms": kern_ms,
            "one_code_ms": one_events_ms, "one_code_device_ms": one_ms,
            "wrapper_host_us": wrapper_us, "chain_call_ms": call_ms,
            "chain_call_device_ms": call_dev_ms,
            "gather_arm_ms": gather_ms, "dense_two_pass_ms": dense_ms}


def _left_by_bincount(dc, yt):
    """The compressed left mult as it was summed before its fixed-order
    layout: torch.bincount of each group's codes weighted by yt's one row
    (float atomics; the call reads the largest code on the host)."""
    from systemml_tpu_torch.compress import device as cla_dev

    out = torch.zeros((1, dc.shape[1]), dtype=yt.dtype, device=yt.device)
    for g in dc.groups:
        if g.coded:
            sums = torch.bincount(g.index(), weights=yt[0],
                                  minlength=g.dict.shape[0]).reshape(1, -1)
            part = cla_dev._mm(sums.to(yt.dtype), g.dict)
        else:
            part = cla_dev._mm(yt, g.vals)
        out.index_copy_(1, g.cols_dev, part.to(out.dtype))
    return out


def time_left_mult(cla, dev, smi) -> dict:
    """The compressed left mult t(X) %*% y (k = 1, fp32) on the block
    LinearRegCG-cla bound: its fixed-order segment sums (compress/device
    Segments) against bincount, by CUDA events, the two within 1e-5
    normwise and a repeat bit-identical; and one group of 65,536 codes
    over as many rows as the block, 60% of them on one code: the layout's
    bytes and build time, its sums against bincount (fp64 within 1e-12 of
    the largest sum), and the peak memory a call adds."""
    from systemml_tpu_torch.compress import device as cla_dev

    c = cla["LinearRegCG"]["auto"]["compressed"][0]
    dc = cla_dev.device_mirror(c)
    gen = torch.Generator(device=dev).manual_seed(8)
    yt = torch.randn(1, CENSUS_N, generator=gen, device=dev)
    left = lambda: cla_dev._left(dc, yt)
    a, b = left(), _left_by_bincount(dc, yt)
    same = bool(torch.equal(a, left()))
    err = normwise(a, b)
    left_ms, bincount_ms = time_ms([left, lambda: _left_by_bincount(dc, yt)])
    coded = [g for g in dc.groups if g.coded]
    layout = sum(seg.nbytes() for seg, _ in dc.streams)
    code_bytes = sum(g.codes.numel() * g.codes.element_size() for g in coded)
    print(f"[cla-left] t(X) %*% y on the Census-shaped block ({CENSUS_N}, "
          f"{CENSUS_M}), {len(coded)} coded groups in {len(dc.streams)} "
          f"segment streams, fp32, on {smi}: "
          f"fixed-order segment sums {left_ms:.4f} ms, bincount "
          f"{bincount_ms:.4f} ms (CUDA events over back-to-back calls); "
          f"normwise {err:.3e} (bar 1e-5), a repeat bit-identical {same}; "
          f"layouts {layout / 1e6:.1f} MB beside {code_bytes / 1e6:.1f} MB "
          f"of codes", flush=True)
    if not err <= 1e-5 or not same:
        fail(f"compressed left mult: {err} from bincount, repeat same {same}")
    n, d = CENSUS_N, 65_536
    codes = torch.randint(0, d, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    codes[torch.rand(n, generator=gen, device=dev) < 0.6] = 123
    y = torch.randn(1, n, generator=gen, device=dev, dtype=torch.float64)
    ext = torch.cat([y, torch.zeros(1, 1, dtype=y.dtype, device=dev)], 1)
    seg = cla_dev.Segments([codes], [d])
    build_ms, sums_ms, count_ms = time_ms([
        lambda: cla_dev.Segments([codes], [d]), lambda: seg.sums(ext),
        lambda: torch.bincount(codes, weights=y[0], minlength=d)], reps=5)
    got = seg.sums(ext)
    ref = torch.bincount(codes, weights=y[0], minlength=d)
    diff = float((got[0] - ref).abs().max() / ref.abs().max())
    same_many = bool(torch.equal(got, seg.sums(ext)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    seg.sums(ext)
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"[cla-left] one group of {d} codes over {n} rows, 60% on one "
          f"code, fp64: layout {seg.nbytes() / 1e6:.2f} MB built in "
          f"{build_ms:.3f} ms; sums {sums_ms:.4f} ms against bincount "
          f"{count_ms:.4f} ms; max difference {diff:.3e} of the largest "
          f"sum (bar 1e-12); a repeat bit-identical {same_many}; a call's "
          f"peak {call_peak / 1e6:.1f} MB over its inputs", flush=True)
    if not diff <= 1e-12 or not same_many:
        fail(f"segment sums of {d} codes: {diff} from bincount, repeat "
             f"same {same_many}")
    return {"census_left_ms": left_ms, "census_bincount_ms": bincount_ms,
            "census_normwise": err, "census_layout_bytes": layout,
            "census_code_bytes": code_bytes, "many_codes_build_ms": build_ms,
            "many_codes_sums_ms": sums_ms, "many_codes_bincount_ms": count_ms,
            "many_codes_layout_bytes": seg.nbytes(),
            "many_codes_call_peak_bytes": call_peak,
            "many_codes_max_rel_diff": diff}


# --------------------------------------------------------------------------
# ALS-CG-ml10m and the ratings summary: K5 (outer) and K3 (multiagg)
# --------------------------------------------------------------------------

def make_ratings(dev):
    """V (ML10M_USERS, ML10M_MOVIES) fp32 of the MovieLens 10M shape, from
    one seeded generator on the card: a Bernoulli pattern at the published
    density; each rating a rank-10 product (mean 3.5, sd about 1.1) plus
    N(0, 0.5^2) noise, rounded to half stars and clipped to 0.5..5.0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    users, movies = ML10M_USERS, ML10M_MOVIES
    a = torch.randn(users, 10, generator=gen, device=dev)
    b = torch.randn(movies, 10, generator=gen, device=dev)
    v = torch.matmul(a, b.T).mul_(0.35).add_(3.5)
    v.add_(torch.randn(users, movies, generator=gen, device=dev), alpha=0.5)
    v.mul_(2.0).round_().div_(2.0).clamp_(0.5, 5.0)
    density = ML10M_RATINGS / (users * movies)
    v.mul_(torch.rand(users, movies, generator=gen, device=dev) < density)
    return v


def als_script(v, rank=None):
    from systemml_tpu_torch.api.mlcontext import dmlFromFile

    s = dmlFromFile(os.path.join(ALG, "ALS-CG.dml")).input("V", v)
    for k, val in dict(ALS_ARGS, **({"rank": rank} if rank else {})).items():
        s.arg(k, val)
    return s.output("L", "R")


def summary_script(v):
    from systemml_tpu_torch.api.mlcontext import dml

    return dml(SUMMARY).input("V", v).output("s", "lo", "hi")


def compile_als():
    """ALS-CG and the ratings summary at optlevel 3 on the card (inputs
    unbound: compile_program reads their names); each builds its plans."""
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.config import get_config, set_config

    old = get_config()
    set_config(config(3))
    try:
        progs = {}
        for name, s in (("ALS-CG", als_script(None)),
                        ("summary", summary_script(None))):
            progs[name] = compile_program(
                s.parse(), clargs=s._args, outputs=s._outputs,
                input_names=list(s._inputs))
        return progs
    finally:
        set_config(old)


def _plan_of(prog, template):
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    hops = [h for h in iter_spoof_hops(prog)
            if h.params["template"] == template]
    if len(hops) != 1:
        fail(f"expected one {template} plan, found {templates_of(prog)}")
    return hops[0]


def _scalar_outer_plan():
    """An outer plan with a host-number leaf a and a 0-d tensor leaf b:
    (X - a * UV) * exp(min(UV, b))."""
    from systemml_tpu_torch.codegen.cplan import CNode

    i = lambda nm: CNode("in", name=nm)
    n = lambda op, *kids: _n(CNode, op, *kids)
    return n("b(*)", n("b(-)", i("X"), n("b(*)", i("a"), i("UV"))),
             n("u(exp)", n("b(min)", i("UV"), i("b"))))


def _check_scalars(label, outs, agains, refs, bar, abs_errs, key,
                   scales=None):
    """outs/agains from the kernel, refs from the plain version in fp64,
    one per aggregate: each error relative to |ref| (to its scale, the sum
    of the summands' magnitudes, for a sum that may cancel to near 0)
    within bar, NaN where ref is NaN, bit-identical repeats. Prints one
    line with the largest error."""
    torch.cuda.synchronize()
    worst, worst_abs, ok, same = 0.0, 0.0, True, True
    for i, (out, again, ref) in enumerate(zip(outs, agains, refs)):
        o, a, r = float(out), float(again), float(ref)
        same &= (o == a) or (o != o and a != a)
        if r != r:
            ok &= o != o
            continue
        abs_err = abs(o - r)
        den = abs(r) if scales is None or scales[i] is None else scales[i]
        err = abs_err / den if den else abs_err
        ok &= err <= bar
        worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
    print(f"[kernel] {label}: largest relative error {worst:.3e} (bar "
          f"{bar:g}), abs {worst_abs:.3e}, NaN as the plain version and "
          f"within the bar {ok}, repeat bit-identical {same}", flush=True)
    if not ok or not same:
        fail(f"{label}: relative error {worst}, NaN places or bar {ok}, "
             f"repeat identical {same}")
    if key is not None:
        abs_errs[key] = max(abs_errs.get(key, 0.0), worst_abs)


def check_outer_kernel(als_hop, v32, dev, kernels, abs_errs) -> None:
    """K5 against outer_plain in fp64 on the card: at ALS-CG-ml10m's shape
    (X its 0/1 pattern, U and V rank 10, its loss plan) and at a ragged
    (100,003, 777, r = 3) X of ratings, fp32 and fp64, with the loss plan
    and a plan of a host-number and a 0-d scalar leaf, without and with
    NaN in X; each twice."""
    gen = torch.Generator(device=dev).manual_seed(7)
    loss_plan, scal_plan = als_hop.params["plan"], _scalar_outer_plan()
    for shape in ((ML10M_USERS, ML10M_MOVIES, 10), (100_003, 777, 3)):
        m, n, r = shape
        if m == ML10M_USERS:
            x32 = (v32 != 0).to(torch.float32)
        else:
            x32 = torch.randint(1, 11, (m, n), generator=gen,
                                device=dev).float().div_(2.0)
            x32.mul_(torch.rand(m, n, generator=gen, device=dev) < 0.3)
        u32 = torch.randn(m, r, generator=gen, device=dev) / math.sqrt(r)
        w32 = torch.randn(n, r, generator=gen, device=dev)
        for dtype in (torch.float32, torch.float64):
            x, u, w = x32.to(dtype), u32.to(dtype), w32.to(dtype)
            extra = {"a": 0.5, "b": torch.tensor(0.75, device=dev,
                                                 dtype=torch.float64)}
            for nan in (False, True):
                if nan:
                    keep = float(x[m // 2, n // 3])
                    x[m // 2, n // 3] = float("nan")
                for label, plan in (("ALS-CG loss", loss_plan),
                                    ("scalar leaves", scal_plan)):
                    before = kernels.outer_kernel.launches
                    out = kernels.outer_kernel(plan, x, u, w, extra)
                    again = kernels.outer_kernel(plan, x, u, w, extra)
                    ref = kernels.outer_plain(plan, x.double(), u.double(),
                                              w.double(), extra)
                    if kernels.outer_kernel.launches != before + 2:
                        fail(f"outer {label}: the kernel did not launch")
                    key = ("outer" if (m, dtype, nan, label) == (
                        ML10M_USERS, torch.float32, False, "ALS-CG loss")
                        else None)
                    _check_scalars(
                        f"outer {label} X ({m}, {n}) r={r} "
                        f"{str(dtype)[6:]}{' NaN in X' if nan else ''}",
                        [out], [again], [ref], SPOOF_BARS[dtype], abs_errs,
                        key)
                    del ref
                if nan:
                    x[m // 2, n // 3] = keep
            del x, u, w
            torch.cuda.empty_cache()
        del x32, u32, w32
    torch.cuda.empty_cache()


def check_multiagg_kernel(summary_hop, v32, progs, dev, kernels,
                          abs_errs) -> None:
    """K3 against multiagg_plain in fp64 on the card: the ratings
    summary's plan over V (fp32 and fp64, with and without a NaN in V)
    and the kernel phase's ragged (100,003, 7) plans of every layout and
    of NaN, every aggregate order of AGG_ORDERS; each twice."""
    plan = summary_hop.params["plan"]
    names = list(summary_hop.params["leaf_names"])
    if len(names) != 4:
        fail(f"the summary's plan has leaves {names}")
    gen = torch.Generator(device=dev).manual_seed(8)

    def cases():   # one at a time: V in fp64 alone is 6.1 GB
        for dtype in (torch.float32, torch.float64):
            vd = v32.to(dtype)
            env = {names[0]: vd, names[1]: vd, names[2]: vd.sum(),
                   names[3]: (vd != 0).sum().to(dtype)}
            yield (f"summary V ({ML10M_USERS}, {ML10M_MOVIES})", plan,
                   names, env, dtype, vd)
        for label, tmpl, rplan, rnames, hop in kernel_plans(progs)[2:]:
            if label == "every op" or tmpl is not None:
                continue
            for dtype in (torch.float32, torch.float64):
                yield (f"{label} (100003, 7)", rplan, rnames,
                       kernel_env(label, hop, rnames, dtype, dev, gen),
                       dtype, None)

    for label, cplan, cnames, env, dtype, poke in cases():
        envd = {k: (t.double() if isinstance(t, torch.Tensor) else t)
                for k, t in env.items()}
        for nan in ((False, True) if poke is not None else (False,)):
            if nan:
                keep = float(poke[123, 456])
                poke[123, 456] = float("nan")
                envd = {k: (t.double() if isinstance(t, torch.Tensor) else t)
                        for k, t in env.items()}
            # a sum's error is held against the sum of |value| (the
            # summary's sum cancels to near 0)
            scale = float(kernels._plain_value(cplan, cnames, envd).abs()
                          .nansum())
            for aggs in AGG_ORDERS:
                before = kernels.multiagg_kernel.launches
                out = kernels.multiagg_kernel(cplan, cnames, aggs, env)
                again = kernels.multiagg_kernel(cplan, cnames, aggs, env)
                ref = kernels.multiagg_plain(cplan, cnames, aggs, envd)
                if kernels.multiagg_kernel.launches != before + 2:
                    fail(f"multiagg {label}: the kernel did not launch")
                key = ("multiagg" if (poke is not None and dtype ==
                                      torch.float32 and not nan) else None)
                _check_scalars(
                    f"multiagg {label} {str(dtype)[6:]} "
                    f"{'NaN ' if nan else ''}aggs {list(aggs)}", out, again,
                    ref, SPOOF_BARS[dtype], abs_errs, key,
                    [scale if a == "sum" else None for a in aggs])
            if nan:
                poke[123, 456] = keep
        del env, envd, poke
        torch.cuda.empty_cache()


def check_rand(dev) -> None:
    """The port's rand() on the card against its rand() on the CPU, bit
    for bit, in fp32 and fp64: ALS-CG's factor draw at the path's shape
    and a ranged, sparse draw."""
    from systemml_tpu_torch.ops import datagen

    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.float64, torch.int64)):
        for rows, cols, lo, hi, sp, seed in (
                (ML10M_USERS, 10, 0.0, 1.0, 1.0, 1234),
                (1000, 1000, -2.5, 3.7, 0.3, 7)):
            a = datagen.rand(rows, cols, lo, hi, sp, seed=seed, dtype=dtype,
                             device=dev)
            b = datagen.rand(rows, cols, lo, hi, sp, seed=seed, dtype=dtype,
                             device="cpu")
            same = bool(torch.equal(a.cpu().view(bits), b.view(bits)))
            print(f"[kernel] rand ({rows}, {cols}) [{lo}, {hi}) sparsity {sp} "
                  f"seed {seed} {str(dtype)[6:]}: card equals CPU bit for bit "
                  f"{same}", flush=True)
            if not same:
                fail(f"rand {rows}x{cols} {dtype}: the card's draw differs "
                     f"from the CPU's")


_LOSS_MARK = "ALS-CG: iterations = "


def run_als(optlevel, v, dev, kernels, regions=True, rank=None,
            profile=True) -> dict:
    """One unprofiled run of ALS-CG-ml10m through MLContext, after a
    warm-up on the first 8,192 users; the launch counters are set to 0
    just before it and read just after. `regions` False: with
    codegen_enabled False. `rank` replaces ALS_ARGS' rank; `profile`
    False skips the run under torch.profiler."""
    from systemml_tpu_torch.api.mlcontext import MLContext

    rank = rank or ALS_ARGS["rank"]
    ml = MLContext(config(optlevel, regions))
    ml.printer = lambda s: None
    ml.execute(als_script(v[:8192], rank))
    lines = []
    ml.printer = lines.append
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer, SpoofSpy() as spy:
        res = ml.execute(als_script(v, rank))
        lo, ro = res.get_tensor("L"), res.get_tensor("R")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    hits = [s for s in lines if s.startswith(_LOSS_MARK)]
    if len(hits) != 1:
        fail(f"ALS-CG optlevel {optlevel} printed {lines}")
    iters = int(hits[0][len(_LOSS_MARK):].split(",")[0])
    loss = float(hits[0].split("loss = ")[1])
    events = dict(ml._stats.estim_counts.items())
    tag = (f"ALS-CG-ml10m{'' if rank == ALS_ARGS['rank'] else f' rank {rank}'}"
           f" optlevel {optlevel}" + ("" if regions else " eager"))
    windows = phase_windows(timer, iters, tag, "outer loop")
    reg = region_report(timer, tag, "ALS-CG", regions)
    print(f"[script] {hits[0]}")
    print(f"[als] {tag}: {iters} outer "
          f"iterations, {secs:.3f} s with parse and compile, "
          f"{ml._stats.run_time:.3f} s executing; "
          f"{windows['iteration_ms']:.3f} ms per outer iteration (device "
          f"window; host {windows['iteration_host_ms']:.3f} ms); launches "
          f"{launches}; events { {k: c for k, c in events.items() if k.startswith(('spoof_', 'spx_', 'cla_'))} }; "
          f"peak allocated {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB "
          f"over the data allocated before the run, V "
          f"{v.numel() * 4 / 1e9:.3f} GB among it); {walk_line(events)}",
          flush=True)
    check_walks(f"ALS-CG optlevel {optlevel}", events, launches)
    for t, nm in ((lo, "L"), (ro, "R")):
        if t.dtype != torch.float32 or t.device != v.device \
                or not bool(torch.isfinite(t).all()) or t.shape[1] != rank:
            fail(f"ALS-CG optlevel {optlevel}: {nm} is {t.dtype} "
                 f"{tuple(t.shape)} on {t.device}, or not finite")
    if events.get("spoof_compile_errors", 0):
        fail(f"ALS-CG optlevel {optlevel}: spoof_compile_errors "
             f"{events['spoof_compile_errors']}")
    if launches["cla_chain"] or events.get("cla_auto_compressed", 0):
        fail(f"ALS-CG optlevel {optlevel}: a value was compressed")
    if optlevel >= 3:
        if launches["spoof_outer"] != iters or iters < 1:
            fail(f"ALS-CG optlevel 3: K5 launched {launches['spoof_outer']} "
                 f"times in {iters} outer iterations")
        if launches["spoof_cell"] < 1:
            fail("ALS-CG optlevel 3: the spoof cell kernel never launched")
        # sum((wrowL * L) * L) and sum((wrowR * R) * R): an (n, 1) main
        # leaf beside an (n, rank) leaf, a layout that the JAX package's
        # kernel refuses too (its _leaf_layout), run by the plain arm
        if events.get("spoof_plain_by_layout", 0) != 2 * iters:
            fail(f"ALS-CG optlevel 3: spoof_plain_by_layout "
                 f"{events.get('spoof_plain_by_layout', 0)}, not the two "
                 f"regularizer plans per outer iteration ({2 * iters})")
    else:
        if any(launches[k] for k in ("spoof_cell", "spoof_row",
                                     "spoof_outer", "spoof_multiagg")):
            fail(f"ALS-CG optlevel 2 launched spoof kernels: {launches}")
        if not events.get("spx_wdivmm_dense", 0):
            fail("ALS-CG optlevel 2 did not run the dense wdivmm arm")
    # device time by kernel and the device's busy share from one more run
    # under torch.profiler; at optlevel 3 also the outer loop's period (K5
    # launches once per outer iteration)
    profile = (profile_main_path(ml, als_script(v, rank), False,
                                 kernel="outer_sum", loop="outer loop")
               if profile else None)
    return {"L": lo, "R": ro, "iterations": iters, "loss": loss,
            "LR": torch.cat([lo.flatten(), ro.flatten()]),
            "profile": profile,
            "cell_sums": spy.most_launched() if spy.counts else None,
            "seconds": secs, "exec_seconds": ml._stats.run_time,
            "launches": launches, "peak_bytes": peak,
            "peak_reserved": peak_reserved, "regions": reg,
            "peak_over_data_bytes": peak - base, "windows": windows,
            "events": {k: c for k, c in events.items()
                       if k.startswith(("spoof_", "spx_", "cla_"))}}


def run_summary(optlevel, v, kernels) -> dict:
    from systemml_tpu_torch.api.mlcontext import MLContext

    ml = MLContext(config(optlevel))
    ml.printer = lambda s: None
    ml.execute(summary_script(v[:8192]))
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    res = ml.execute(summary_script(v))
    vals = {k: float(res.get(k)) for k in ("s", "lo", "hi")}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    events = dict(ml._stats.estim_counts.items())
    print(f"[summary] ratings summary optlevel {optlevel}: {vals}, "
          f"{secs:.3f} s with parse and compile; launches {launches}; "
          f"{walk_line(events)}; spoof_plain_by_layout "
          f"{events.get('spoof_plain_by_layout', 0)}", flush=True)
    check_walks(f"summary optlevel {optlevel}", events, launches)
    want = 1 if optlevel >= 3 else 0
    if launches["spoof_multiagg"] != want:
        fail(f"summary optlevel {optlevel}: K3 launched "
             f"{launches['spoof_multiagg']} times, not {want}")
    if events.get("spoof_plain_by_layout", 0) or \
            events.get("spoof_compile_errors", 0):
        fail(f"summary optlevel {optlevel}: {events}")
    return {"values": vals, "seconds": secs, "launches": launches}


def als_paths(v, progs, dev, kernels) -> dict:
    """ALS-CG-ml10m at optlevels 3 and 2, then the ratings summary at 3
    and 2, on V."""
    for name in ("ALS-CG", "summary"):
        for t in templates_of(progs[name]):
            print(f"[plans] {name} optlevel 3: {t[0]} {t[1]}: {t[2]}")
    runs = {o: run_als(o, v, dev, kernels) for o in (3, 2)}
    eag = run_als(3, v, dev, kernels, regions=False)
    versus_eager = compare_eager("ALS-CG-ml10m optlevel 3", runs[3], eag,
                                 key="LR")
    del eag
    diffs = {}
    for nm in ("L", "R"):
        a, b = runs[3][nm].double(), runs[2][nm].double()
        diffs[nm] = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    loss_rel = abs(runs[3]["loss"] - runs[2]["loss"]) / abs(runs[2]["loss"])
    print(f"[als] ALS-CG-ml10m: |optlevel 3 - optlevel 2| / |optlevel 2|: L "
          f"{diffs['L']:.3e}, R {diffs['R']:.3e}, loss {loss_rel:.3e} (bars "
          f"1e-3); outer iterations {runs[3]['iterations']} / "
          f"{runs[2]['iterations']}; ms per outer iteration "
          f"{runs[3]['windows']['iteration_ms']:.3f} / "
          f"{runs[2]['windows']['iteration_ms']:.3f}", flush=True)
    if not (diffs["L"] <= 1e-3 and diffs["R"] <= 1e-3 and loss_rel <= 1e-3):
        fail(f"ALS-CG optlevel 3 is {diffs}, loss {loss_rel} from optlevel 2")
    summ = {o: run_summary(o, v, kernels) for o in (3, 2)}
    z_abs = float((v - v.sum(dtype=torch.float64) / (v != 0).sum())
                  .mul_(v != 0).abs().sum(dtype=torch.float64))
    s3, s2 = summ[3]["values"], summ[2]["values"]
    errs = {"s": abs(s3["s"] - s2["s"]) / z_abs,
            "lo": abs(s3["lo"] - s2["lo"]) / abs(s2["lo"]),
            "hi": abs(s3["hi"] - s2["hi"]) / abs(s2["hi"])}
    print(f"[summary] optlevel 3 against 2: s {errs['s']:.3e} of sum|Z| = "
          f"{z_abs:.6e} (bar 1e-6), lo {errs['lo']:.3e}, hi {errs['hi']:.3e} "
          f"relative (bars 1e-5)", flush=True)
    if not (errs["s"] <= 1e-6 and errs["lo"] <= 1e-5 and errs["hi"] <= 1e-5):
        fail(f"ratings summary optlevel 3 is {errs} from optlevel 2")
    out = {f"optlevel{o}": {k: val for k, val in r.items()
                            if k not in ("L", "R", "LR", "cell_sums")}
           for o, r in runs.items()}
    out["versus_eager"] = versus_eager
    out.update({"diff_from_optlevel2": diffs, "loss_rel_diff": loss_rel,
                "templates": templates_of(progs["ALS-CG"]),
                "summary": {f"optlevel{o}": r for o, r in summ.items()},
                "summary_errors": errs,
                "factors": (runs[3]["L"], runs[3]["R"]),
                "cell_sums": runs[3]["cell_sums"]})
    return out


# --------------------------------------------------------------------------
# the sparse plane's paths: ALS-CG over a CSR V (runtime/sparse.py)
# --------------------------------------------------------------------------

# the Netflix Prize ratings (Bennett and Lanning, KDD Cup 2007): users,
# movies, ratings; a dense fp32 V of that shape takes 34.13 GB
NETFLIX_USERS, NETFLIX_MOVIES, NETFLIX_RATINGS = 480_189, 17_770, 100_480_507
NETFLIX_DENSE_BYTES = NETFLIX_USERS * NETFLIX_MOVIES * 4
# the one reason a region over a sparse invariant may be refused for
SPARSE_REFUSAL = "sparse view"
SPARSE_EVENTS = ("spx_", "spmm_", "spgemm_", "sp_tsmm_", "sddmm",
                 "sparse_densify")


def make_netflix(dev):
    """V of the Netflix Prize shape as CSR on the card, from one seeded
    generator: cell keys drawn uniformly over users x movies, sorted, the
    distinct ones kept and topped up to NETFLIX_RATINGS; each rating as
    make_ratings' (a rank-10 product plus N(0, 0.5^2) noise, rounded to
    half stars in 0.5..5.0). No dense (users, movies) tensor is made.
    Returns the torch sparse CSR tensor and the seconds it took."""
    import warnings

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2)
    users, movies, n = NETFLIX_USERS, NETFLIX_MOVIES, NETFLIX_RATINGS
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    while keys.numel() < n:
        draw = torch.randint(users * movies, (n - keys.numel(),),
                             generator=gen, device=dev)
        keys = torch.unique(torch.cat([keys, draw]))   # sorted, distinct
    rows, cols = keys // movies, keys % movies
    del keys
    a = torch.randn(users, 10, generator=gen, device=dev)
    b = torch.randn(movies, 10, generator=gen, device=dev)
    vals = torch.zeros(n, device=dev)
    for i in range(10):
        vals.addcmul_(a[:, i][rows], b[:, i][cols])
    vals.mul_(0.35).add_(3.5)
    vals.add_(torch.randn(n, generator=gen, device=dev), alpha=0.5)
    vals.mul_(2.0).round_().div_(2.0).clamp_(0.5, 5.0)
    indptr = torch.searchsorted(rows, torch.arange(users + 1, device=dev))
    del rows, a, b
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        v = torch.sparse_csr_tensor(indptr, cols, vals, size=(users, movies),
                                    check_invariants=False)
    torch.cuda.synchronize()
    return v, time.perf_counter() - t0


def loss_fp64(v, lo, ro, reg):
    """ALS-CG's loss of (L, R) in one plain fp64 pass over V's stored
    cells: sum (v - l . r)^2 + reg (|L|^2 + |R|^2)."""
    crow, col, val = v.crow_indices(), v.col_indices(), v.values()
    rows = torch.repeat_interleave(
        torch.arange(v.shape[0], device=val.device), crow.diff(),
        output_size=val.numel())
    lf, rf = lo.double(), ro.double()
    pred = torch.zeros(val.numel(), dtype=torch.float64, device=val.device)
    for k in range(lf.shape[1]):
        pred.addcmul_(lf[:, k][rows], rf[:, k][col])
    d = val.double() - pred
    return float((d * d).sum() + reg * ((lf * lf).sum() + (rf * rf).sum()))


def run_sparse_als(label, v, optlevel, dev, kernels, regions=True,
                   profile=False) -> dict:
    """One unprofiled run of ALS-CG over the CSR tensor v through MLContext
    (bound as it is: its own tensors on the card), after a warm-up on its
    first 8,192 users; the launch counters and the densify counts are set
    to 0 just before it and read just after. With `profile`, once more
    under torch.profiler (the device's busy share)."""
    from systemml_tpu_torch.api.mlcontext import MLContext
    from systemml_tpu_torch.runtime import sparse as sp

    ml = MLContext(config(optlevel, regions))
    ml.printer = lambda s: None
    head = sp.SparseMatrix.from_csr_tensor(v).slice(0, 8192, 0, v.shape[1])
    ml.execute(als_script(head.to_csr_tensor()))
    del head
    lines = []
    ml.printer = lines.append
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sp.DENSIFY_COUNTS.clear()
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        res = ml.execute(als_script(v))
        lo, ro = res.get_tensor("L"), res.get_tensor("R")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    densify = {f"{m}x{n}": c for (m, n), c in sp.DENSIFY_COUNTS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    hits = [ln for ln in lines if ln.startswith(_LOSS_MARK)]
    if len(hits) != 1:
        fail(f"{label} optlevel {optlevel} printed {lines}")
    iters = int(hits[0][len(_LOSS_MARK):].split(",")[0])
    loss = float(hits[0].split("loss = ")[1])
    events = dict(ml._stats.estim_counts.items())
    tag = f"{label} optlevel {optlevel}" + ("" if regions else " eager")
    windows = phase_windows(timer, iters, tag, "outer loop")
    reg = region_report(timer, tag, label, regions, may_refuse=SPARSE_REFUSAL)
    views = {r["label"]: r["views"] for r in reg.get("regions", ())
             if r.get("views")}
    view_ms = sum(w[0] for w in timer.windows["views"])
    counters = {k: c for k, c in events.items() if k.startswith(SPARSE_EVENTS)}
    print(f"[script] {hits[0]}")
    print(f"[sparse] {tag}: {iters} outer iterations, {secs:.3f} s with "
          f"parse and compile, {ml._stats.run_time:.3f} s executing; "
          f"{windows['iteration_ms']:.3f} ms per outer iteration (device "
          f"window of the loop, its views' set-up left out; host "
          f"{windows['iteration_host_ms']:.3f} ms); in the graph "
          f"{reg.get('graph_iteration_ms', float('nan')):.3f} ms per "
          f"iteration; views {views or 'none'} built in {view_ms:.1f} ms "
          f"host; sparse counters {counters}; launches {launches}; spoof "
          f"{ {k: c for k, c in events.items() if k.startswith('spoof_')} }; "
          f"densifies by shape {densify or 'none'}; peak allocated "
          f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB over the data "
          f"allocated before the run), reserved {peak_reserved / 1e9:.3f} GB",
          flush=True)
    for t, nm, rows in ((lo, "L", v.shape[0]), (ro, "R", v.shape[1])):
        if t.dtype != torch.float32 or t.device.type != "cuda" \
                or tuple(t.shape) != (rows, 10) \
                or not bool(torch.isfinite(t).all()):
            fail(f"{tag}: {nm} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                 f"or not finite")
    if events.get("spoof_compile_errors", 0):
        fail(f"{tag}: spoof_compile_errors {events['spoof_compile_errors']}")
    if launches["cla_chain"] or launches["mmchain"]:
        fail(f"{tag}: launched K6 or K1 ({launches}); neither is on ALS-CG's "
             f"path")
    out = {"L": lo, "R": ro, "iterations": iters, "loss": loss,
           "seconds": secs, "exec_seconds": ml._stats.run_time,
           "launches": launches, "peak_bytes": peak,
           "peak_reserved": peak_reserved, "peak_over_data_bytes": peak - base,
           "windows": windows, "regions": reg, "views": views,
           "views_host_ms": view_ms, "sparse_counters": counters,
           "densify": densify}
    if profile:
        # the timed run's graph and its pool go first
        del res, timer
        torch.cuda.empty_cache()
        out["profile"] = profile_main_path(ml, als_script(v), False,
                                           kernel="set_cond",
                                           loop="region (set_cond to set_cond)")
    return out


def _normwise_lr(a, b) -> dict:
    return {nm: float(torch.linalg.norm(a[nm].double() - b[nm].double())
                      / torch.linalg.norm(b[nm].double()))
            for nm in ("L", "R")}


def sparse_paths(ratings, als, dev, kernels) -> dict:
    """(a) ALS-CG-ml10m-sparse: the MovieLens-10M-shaped V of the dense
    path bound as a CSR tensor, at optlevel 3 with regions (the views the
    reference's rule gives: dense) and eagerly (codegen_enabled False:
    the CSR arms), each within 1e-3 of the dense-V run at optlevel 3;
    (b) ALS-CG-netflix: a Netflix-Prize-shaped V made as CSR on the card,
    at optlevel 3 with regions (ELL views, K2), optlevel 3 eagerly and
    optlevel 2 with regions, the three within 1e-3 of each other and each
    loss within 1e-3 of its recomputation in fp64; peak allocated below
    one dense V, no densify of a (users, movies) or (movies, users)
    matrix, K2 launched at optlevel 3."""
    out = {}
    torch.cuda.empty_cache()
    v = ratings.to_sparse_csr()
    dense = {"L": als["factors"][0], "R": als["factors"][1],
             "loss": als["optlevel3"]["loss"]}
    a = {"regions": run_sparse_als("ALS-CG-ml10m-sparse", v, 3, dev, kernels),
         "eager": run_sparse_als("ALS-CG-ml10m-sparse", v, 3, dev, kernels,
                                 regions=False)}
    for mode, r in a.items():
        d = _normwise_lr(r, dense)
        d["loss"] = abs(r["loss"] - dense["loss"]) / abs(dense["loss"])
        r["versus_dense_v"] = d
        print(f"[sparse] ALS-CG-ml10m-sparse optlevel 3 {mode} against the "
              f"dense-V run at optlevel 3: L {d['L']:.3e}, R {d['R']:.3e}, "
              f"loss {d['loss']:.3e} (bars 1e-3); views {r['views'] or 'none'}",
              flush=True)
        if not max(d.values()) <= 1e-3:
            fail(f"ALS-CG-ml10m-sparse {mode}: {d} from the dense-V run")
    del v
    out["ALS-CG-ml10m-sparse"] = a
    torch.cuda.empty_cache()
    v, csr_s = make_netflix(dev)
    nnz = v.values().numel()
    rows_k = int(v.crow_indices().diff().max())
    print(f"[netflix] V ({NETFLIX_USERS}, {NETFLIX_MOVIES}) fp32 as CSR on "
          f"the card: {nnz} ratings ({100 * nnz / (NETFLIX_USERS * NETFLIX_MOVIES):.4f}% "
          f"dense), mean rating {float(v.values().double().mean()):.4f}, "
          f"longest user row {rows_k}; made in {csr_s:.2f} s; a dense fp32 V "
          f"would take {NETFLIX_DENSE_BYTES / 1e9:.2f} GB", flush=True)
    if nnz != NETFLIX_RATINGS:
        fail(f"the Netflix-shaped V has {nnz} ratings, not {NETFLIX_RATINGS}")
    b = {"optlevel3": run_sparse_als("ALS-CG-netflix", v, 3, dev, kernels,
                                     profile=True),
         "optlevel3_eager": run_sparse_als("ALS-CG-netflix", v, 3, dev,
                                           kernels, regions=False),
         "optlevel2": run_sparse_als("ALS-CG-netflix", v, 2, dev, kernels)}
    ref = b["optlevel3"]
    shapes = {f"{NETFLIX_USERS}x{NETFLIX_MOVIES}",
              f"{NETFLIX_MOVIES}x{NETFLIX_USERS}"}
    for mode, r in b.items():
        d = _normwise_lr(r, ref) if r is not ref else {"L": 0.0, "R": 0.0}
        recomputed = loss_fp64(v, r["L"], r["R"], ALS_ARGS["reg"])
        d["loss_fp64"] = abs(r["loss"] - recomputed) / abs(recomputed)
        r["versus_optlevel3_regions"] = d
        r["loss_fp64"] = recomputed
        print(f"[netflix] {mode}: against optlevel 3 with regions L "
              f"{d['L']:.3e}, R {d['R']:.3e}; loss {r['loss']:.6e} against "
              f"{recomputed:.6e} recomputed in fp64 over the ratings, "
              f"{d['loss_fp64']:.3e} relative (bars 1e-3); peak allocated "
              f"{r['peak_bytes'] / 1e9:.3f} GB (one dense V "
              f"{NETFLIX_DENSE_BYTES / 1e9:.2f} GB); densifies {r['densify'] or 'none'}",
              flush=True)
        if not max(d.values()) <= 1e-3:
            fail(f"ALS-CG-netflix {mode}: {d}")
        if r["peak_bytes"] >= NETFLIX_DENSE_BYTES:
            fail(f"ALS-CG-netflix {mode}: peak allocated {r['peak_bytes']} B "
                 f">= one dense V")
        if shapes & set(r["densify"]):
            fail(f"ALS-CG-netflix {mode}: densified {r['densify']}")
    if b["optlevel3"]["launches"]["spoof_cell"] < 1:
        fail("ALS-CG-netflix optlevel 3: K2 never launched")
    if not b["optlevel3"]["views"] or any(
            set(vs.values()) != {"ell"} for vs in b["optlevel3"]["views"].values()):
        fail(f"ALS-CG-netflix optlevel 3: views {b['optlevel3']['views']}, "
             f"not ELL")
    b["csr_seconds"] = csr_s
    b["views_host_ms"] = {m: r["views_host_ms"] for m, r in b.items()
                          if isinstance(r, dict)}
    del v
    out["ALS-CG-netflix"] = b
    torch.cuda.empty_cache()
    return out


def time_outer_and_multiagg(als, v, progs, smi, abs_errs, kernels) -> list:
    """K5 and K3 at ALS-CG-ml10m's shape against their plain versions and
    bounds: K5 on the loss plan with X = V's 0/1 pattern and the optlevel-3
    run's L and R, K3 on the summary's plan over V. Returns their
    records."""
    loss_hop = _plan_of(progs["ALS-CG"], "outer")
    plan = loss_hop.params["plan"]
    lf, rf = als["factors"]
    x = (v != 0).to(torch.float32)
    m, n = x.shape
    r = lf.shape[1]
    kern_ms, plain_ms, mm_ms = time_ms([
        lambda: kernels.outer_kernel(plan, x, lf, rf, {}),
        lambda: kernels.outer_plain(plan, x, lf, rf, {}),
        lambda: torch.matmul(lf, rf.T),
    ], reps=10)
    nbytes = (x.numel() + lf.numel() + rf.numel()) * 4 + 4
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * (2.0 * r + plan_ops(plan)) * m * n / FP32_OPS_PER_S
    outer_bound = max(bytes_ms, ops_ms)
    print(f"[times] spoof_outer {plan.pretty()} X ({m}, {n}) r={r} fp32 on "
          f"{smi}: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{outer_bound:.4f} ms (bytes {bytes_ms:.4f}, operations "
          f"{ops_ms:.4f}); yardstick torch.matmul(U, V.T) alone (the "
          f"unfused route's first step) {mm_ms:.4f} ms; no single torch call "
          f"computes the outer template", flush=True)
    del x
    torch.cuda.empty_cache()
    hop = _plan_of(progs["summary"], "multiagg")
    mplan, names = hop.params["plan"], list(hop.params["leaf_names"])
    aggs = list(hop.params["aggs"])
    env = {names[0]: v, names[1]: v, names[2]: v.sum(),
           names[3]: (v != 0).sum().to(torch.float32)}
    magg_ms, mplain_ms = time_ms([
        lambda: kernels.multiagg_kernel(mplan, names, aggs, env),
        lambda: kernels.multiagg_plain(mplan, names, aggs, env),
    ], reps=10)
    mb_ms, mb_by = spoof_bound(mplan, env, 4 * len(aggs), m * n)
    print(f"[times] spoof_multiagg {mplan.pretty()} {aggs} over V ({m}, {n}) "
          f"fp32 on {smi}: kernel {magg_ms:.4f} ms, plain (the unfused torch "
          f"sequence, the yardstick) {mplain_ms:.4f} ms, bound {mb_ms:.4f} "
          f"ms ({mb_by}); no single torch call computes the multi-aggregate "
          f"template", flush=True)
    return [{
        "name": "spoof_outer", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/spoof.cuh",
        "replaces": "systemml_tpu/codegen/kernels.py:419 outer_sum_kernel",
        "launches": als["optlevel3"]["launches"]["spoof_outer"],
        "max_abs_err": abs_errs["outer"], "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": outer_bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "yardstick_matmul_ms": mm_ms,
        "plan": plan.pretty()}, {
        "name": "spoof_multiagg", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/spoof.cuh",
        "replaces": "systemml_tpu/codegen/kernels.py:242 multiagg_kernel",
        "launches": als["summary"]["optlevel3"]["launches"]["spoof_multiagg"],
        "max_abs_err": abs_errs["multiagg"], "ms": magg_ms,
        "plain_ms": mplain_ms, "bound_ms": mb_ms, "bound_by": mb_by,
        "library_ms": None, "yardstick_unfused_ms": mplain_ms,
        "plan": mplan.pretty(), "aggs": aggs}]


def time_cell_beyond_l2svm(als, v, als_progs, smi, kernels) -> dict:
    """K2 beyond l2-svm's plan, each against its plain version and bound:
    the cell sum that ALS-CG-ml10m's optlevel-3 run launched most, at its
    last call's own inputs (device time per call, torch.profiler), and the
    elementwise arm on an (m, n > 1) plan, the summary's over V (it writes
    3.058 GB: CUDA events). Prints each with its leaves' classes (which
    walk it takes)."""
    out = {}
    if als["cell_sums"] is not None:
        count, (plan, names, env, variant) = als["cell_sums"]
        main = env[kernels._matrices(names, env)[0]]
        fns = [lambda: kernels.cell_kernel(plan, names, "sum", env, variant),
               lambda: kernels.cell_plain(plan, names, "sum", env)]
        k_ms, p_ms = device_ms(fns[0]), device_ms(fns[1])
        cold_ms = device_ms(fns[0], cold=True)
        b_ms, b_by = spoof_bound(plan, env, main.element_size(),
                                 main.numel())
        classes = kernels.leaf_classes(plan, "cell", env, variant)
        print(f"[times] spoof_cell sum ALS-CG's most launched cell sum "
              f"({count} launches in its run) {plan.pretty()} over "
              f"{tuple(main.shape)} on {smi}: device time per call kernel "
              f"{cold_ms:.4f} ms with the L2 cache evicted before each call "
              f"({k_ms:.4f} ms warm), plain {p_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}); leaves {classes}", flush=True)
        out["als_cg_sum"] = {"plan": plan.pretty(), "launches": count,
                             "shape": list(main.shape), "ms": cold_ms,
                             "warm_l2_ms": k_ms,
                             "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "leaf_classes": classes}
    hop = _plan_of(als_progs["summary"], "multiagg")
    plan, names = hop.params["plan"], list(hop.params["leaf_names"])
    env = {names[0]: v, names[1]: v, names[2]: v.sum(),
           names[3]: (v != 0).sum().to(torch.float32)}
    k_ms, p_ms = time_ms([lambda: kernels.cell_kernel(plan, names, None, env),
                          lambda: kernels.cell_plain(plan, names, None, env)],
                         reps=5, warm=1)
    b_ms, b_by = spoof_bound(plan, env, v.numel() * v.element_size(),
                             v.numel())
    classes = kernels.leaf_classes(plan, "cell", env)
    print(f"[times] spoof_cell elementwise {plan.pretty()} over V "
          f"{tuple(v.shape)} fp32 on {smi}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); leaves {classes}",
          flush=True)
    out["map"] = {"plan": plan.pretty(), "shape": list(v.shape), "ms": k_ms,
                  "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "leaf_classes": classes}
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the CLI and io/, the buffer pool, the whole-block compile, JMLC
# --------------------------------------------------------------------------

# the pool phase: three derived copies of the 8 GB X in blocks of their
# own (an if on a runtime value splits them), each reduced later, and a
# loop whose invariant input (A) the pool evicted before its entry
POOL_SCRIPT = """
gate = as.scalar(rand(rows=1, cols=1, min=1, max=1, seed=9))
A = X * 2
if (gate > 0) { s1 = sum(A) }
B = X + 1
if (gate > 0) { s2 = sum(B) }
C = X * X
if (gate > 0) { s3 = sum(C) }
if (gate > 0) { ta = sum(A) / 2 }
if (gate > 0) { tb = sum(B) - 1 }
if (gate > 0) { tc = sum(C) }
t = ta + tb + tc
i = 0
acc = 0.0
while (i < 3) {
  acc = acc + sum(A) / (i + 1)
  i = i + 1
}
"""
# the working set of POOL_SCRIPT's largest block: each block reads or
# writes one derived copy of X beside X
POOL_WORKING_SCRIPT = "A = X * 2\ns1 = sum(A)"
POOL_OUTPUTS = ("s1", "s2", "s3", "t", "acc")
# below half the 24 GB that A, B and C hold live together
POOL_BUDGET = 11e9
JMLC_BATCH, JMLC_CALLS = 1_000, 200
# the prepared scripts of `[jmlc]`, their inputs beside X, and whether
# the block runs as a graph: one product (one op, no graph), and a
# softmax scorer (scripts/nn/layers/affine.dml and softmax.dml's
# forward, inlined)
JMLC_SCRIPTS = {
    "product": ("yhat = X %*% B", ["B"], False),
    "softmax": ("Z = X %*% W + b\nE = exp(Z - rowMaxs(Z))\n"
                "yhat = E / rowSums(E)", ["W", "b"], True),
}


# --------------------------------------------------------------------------
# parfor on worker lanes, frames and transform
# --------------------------------------------------------------------------

# StepGLM's planted model on the Census X: four columns (0-based) and
# their weights (norm 1.97)
STEPGLM_PLANTED = (3, 17, 41, 60)
STEPGLM_W = (1.2, -1.0, 0.8, -0.9)
STEPGLM_PARFOR = "parfor (j in 1:m, check=0)"
UNIVAR_PARFOR = "parfor (j in 1:m, check=0)"
# transform's frame: the Census codes' first rows, as host strings
TRANSFORM_ROWS = 200_000
TRANSFORM_DUMMY = 4


class ParforSpy:
    """For the duration of a with-block, wraps ParForBlock.execute (each
    parfor's host window, synchronized on both ends, and its plan; the
    parfor numbered `profile` (from 0) runs under torch.profiler, which
    gives the device's busy share over it, and its window is left out of
    `calls`) and Program.execute (the program run)."""

    def __init__(self, profile: Optional[int] = None):
        self.profile = profile
        self.busy = None

    def __enter__(self):
        from systemml_tpu_torch.runtime import parfor, program

        self.calls = []
        self.seen = 0
        self.merge_ms = []
        self.program = None
        self._merge = parfor.merge_results

        def merge(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._merge(*args, **kwargs)
            torch.cuda.synchronize()
            self.merge_ms.append(1e3 * (time.perf_counter() - t0))

        parfor.merge_results = merge
        self._pf = program.ParForBlock.execute
        self._px = program.Program.execute
        spy = self

        def pf_execute(pb, ec):
            torch.cuda.synchronize()
            spy.seen += 1
            if spy.seen - 1 == spy.profile:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    with torch.profiler.record_function("parfor"):
                        spy._pf(pb, ec)
                    torch.cuda.synchronize()
                spy.busy = _busy_share(prof)
                return
            t0 = time.perf_counter()
            spy._pf(pb, ec)
            torch.cuda.synchronize()
            spy.calls.append((t0, time.perf_counter(), pb.last_plan))

        def px_execute(prog, *args, **kwargs):
            spy.program = prog
            return spy._px(prog, *args, **kwargs)

        program.ParForBlock.execute = pf_execute
        program.Program.execute = px_execute
        return self

    def __exit__(self, *exc):
        from systemml_tpu_torch.runtime import parfor, program

        parfor.merge_results = self._merge
        program.ParForBlock.execute = self._pf
        program.Program.execute = self._px


def _loop_variant(path: str, head: str, loop: str) -> str:
    """The script's text with its parfor head replaced: `for` a plain for
    loop, `par=K` the parfor with that degree, "" as it is."""
    with open(os.path.join(ALG, path)) as f:
        src = f.read()
    if head not in src:
        fail(f"{path} has no '{head}'")
    if loop == "for":
        return src.replace(head, "for (j in 1:m)")
    if loop:
        return src.replace(head, head[:-1] + f", {loop})")
    return src


def _lanes(program) -> dict:
    """Region captures and graph launches per parfor lane, summed over the
    program's regions (runtime/loopfuse.py record["lanes"])."""
    from systemml_tpu_torch.runtime import loopfuse

    out = {}
    for r in loopfuse.region_report(program):
        for lane, c in (r.get("lanes") or {}).items():
            acc = out.setdefault(int(lane), {"captures": 0, "launches": 0})
            acc["captures"] += c["captures"]
            acc["launches"] += c["launches"]
    return dict(sorted(out.items()))


def _busy_share(prof) -> dict:
    """The device's busy share over a parfor: the union of the kernel
    intervals that start inside its "parfor" profiler range, over the
    range's length (lanes overlap: a plain sum would count a moment
    twice). The range's own device-side mirror, which spans it whole, is
    no kernel. "not measured" when the profiler recorded no kernels."""
    from torch.autograd import DeviceType

    evs = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end) for e in evs
                    if e.name == "parfor"
                    and e.device_type == DeviceType.CPU)
    ks = sorted((e.time_range.start, e.time_range.end) for e in evs
                if e.device_type == DeviceType.CUDA and e.name != "parfor")
    if not ranges or not ks:
        return {"busy_share": "not measured"}
    busy = span = 0.0
    for r0, r1 in ranges:
        mine = [(max(a, r0), min(b, r1)) for a, b in ks if r0 <= a < r1]
        span += r1 - r0
        end = r0
        for a, b in mine:
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
    return {"busy_share": busy / span, "parfor_ms": span / 1e3,
            "kernel_union_ms": busy / 1e3, "kernels": len(ks)}


def run_stepglm(data, optlevel, loop, dev, kernels, profile=None,
                fault: str = "") -> dict:
    """One run of StepGLM.dml (its defaults: logit, tol 1e-8, moi 25, thr
    0.01) on the Census X and the planted y, through MLContext();
    `profile`: the stepwise pass whose parfor runs under torch.profiler
    (left out of the seconds per pass); `fault`: a fault-injection spec
    armed for the run."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml

    cfg = config(optlevel)
    if fault:
        cfg.fault_injection = fault
        cfg.resil_backoff_base_s = 0.01
    ml = MLContext(cfg)
    lines = []
    ml.printer = lines.append
    src = _loop_variant("StepGLM.dml", STEPGLM_PARFOR, loop)
    script = (dml(src)
              .input("X", data["X"]).input("y", data["y_glm"])
              .output("B", "sel_order", "n_sel", "aic_best"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    with ParforSpy(profile) as spy:
        t0 = time.perf_counter()
        res = ml.execute(script)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev) - base
    n_sel = int(res.get_scalar("n_sel"))
    sel = [int(v) for v in res.get_tensor("sel_order")[:n_sel, 0].tolist()]
    windows = [t1 - t0 for t0, t1, _ in spy.calls]
    plan = spy.calls[0][2] if spy.calls and spy.calls[0][2] else None
    out = {"out": res.get_tensor("B"), "selected": sel, "n_sel": n_sel,
           "aic": float(res.get_scalar("aic_best")), "seconds": secs,
           "passes": spy.seen if loop != "for" else None,
           "pass_s": (sum(windows) / len(windows)) if windows else None,
           "pass_windows_s": windows,
           "plan": plan.describe() if plan is not None else None,
           "merge_ms": (sum(spy.merge_ms) / len(spy.merge_ms)
                        if spy.merge_ms else None),
           "lanes": _lanes(spy.program), "launches": launches,
           "peak_bytes_over_data": peak,
           "stats": dict(ml._stats.estim_counts),
           "resil": dict(ml._stats.resil_counts.items())}
    if spy.busy is not None:
        out.update(spy.busy)
    return out


def stepglm_data(data, dev) -> set:
    """y ~ Bernoulli(sigmoid(X[:, P] w)) on the card into data["y_glm"];
    returns P's 1-based columns."""
    x = data["X"]
    gen = torch.Generator(device=dev).manual_seed(12)
    w = torch.tensor(STEPGLM_W, device=dev).reshape(-1, 1)
    eta = x[:, list(STEPGLM_PLANTED)] @ w
    data["y_glm"] = (torch.rand(eta.shape, generator=gen, device=dev)
                     < torch.sigmoid(eta)).to(torch.float32)
    data["w_norm"] = float(w.norm())
    return {c + 1 for c in STEPGLM_PLANTED}


def stepglm_phase(data, dev, kernels, smi) -> dict:
    """`[parfor-stepglm]`: StepGLM at the Census shape with a planted
    logit model; at optlevel 3 with regions and at optlevel 2, each with
    the parfor at its default par, with par=8, with par=1 and as a for
    loop; the default and par=8 runs at optlevel 3 run their second
    pass's parfor under torch.profiler (the busy share). The selected set is the same in the runs of an
    optlevel, the planted columns lead it, B is within 1e-5 of the for
    run's. Each run prints its line when it ends."""
    planted = stepglm_data(data, dev)
    print(f"[parfor-stepglm] X ({CENSUS_N}, {CENSUS_M}) fp32 (the Census "
          f"shape), y ~ Bernoulli(sigmoid(X[:, {sorted(planted)}] w)), |w| "
          f"= {data['w_norm']:.3f}, mean(y) "
          f"{float(data['y_glm'].mean()):.4f}; on {smi}", flush=True)
    out = {}
    for optlevel in (3, 2):
        runs = {}
        prof = 1 if optlevel == 3 else None
        variants = [("for", "for", None), ("parfor", "", prof),
                    ("par=8", "par=8", prof), ("par=1", "par=1", None)]
        for label, loop, prof in variants:
            r = runs[label] = run_stepglm(data, optlevel, loop, dev,
                                          kernels, profile=prof)
            ref = runs["for"]
            diff = float(torch.linalg.norm(r["out"].double()
                                           - ref["out"].double())
                         / torch.linalg.norm(ref["out"].double()))
            r["B_vs_for"] = diff
            print(f"[parfor-stepglm] optlevel {optlevel} {label}: selected "
                  f"{r['selected']} (AIC {r['aic']:.3f}); {r['seconds']:.3f} "
                  f"s in all, {r['passes']} passes of "
                  f"{r['pass_s'] if r['pass_s'] is None else round(r['pass_s'], 4)}"
                  f" s each (parfor windows); plan {r['plan']}; merge "
                  f"{r['merge_ms']} ms a pass (synchronized); |B - B(for)| "
                  f"/ |B(for)| = {diff:.3e} (bar 1e-5); peak allocated over "
                  f"the data {r['peak_bytes_over_data'] / 1e9:.3f} GB; "
                  f"kernel launches {r['launches']}; region captures and "
                  f"graph launches per lane {r['lanes']}"
                  + (f"; device busy {100 * r['busy_share']:.1f}% over the "
                     f"second pass's parfor, under torch.profiler "
                     f"({r['kernel_union_ms']:.1f} of "
                     f"{r['parfor_ms']:.1f} ms)"
                     if isinstance(r.get("busy_share"), float) else
                     f"; busy share {r['busy_share']}"
                     if "busy_share" in r else "")
                  + f"; on {smi}", flush=True)
            if r["selected"] != ref["selected"]:
                fail(f"[parfor-stepglm] optlevel {optlevel} {label} selected "
                     f"{r['selected']}, the for run {ref['selected']}")
            if set(r["selected"][:4]) != planted:
                fail(f"[parfor-stepglm] optlevel {optlevel} {label}: the "
                     f"planted columns {sorted(planted)} do not lead "
                     f"{r['selected']}")
            if not diff <= 1e-5:
                fail(f"[parfor-stepglm] optlevel {optlevel} {label}: B is "
                     f"{diff} from the for run's")
            if loop != "for" and not r["lanes"]:
                fail(f"[parfor-stepglm] optlevel {optlevel} {label}: no "
                     f"region ran on a worker lane")
        out[f"optlevel{optlevel}"] = {
            k: {kk: vv for kk, vv in r.items() if kk != "out"}
            for k, r in runs.items()}
        if optlevel == 3:
            # `[remote]`'s reference
            data["stepglm_for"] = {"B": runs["for"]["out"],
                                   "selected": runs["for"]["selected"]}
        del runs
    o3 = out["optlevel3"]
    print(f"[parfor-stepglm] optlevel 3, s per stepwise pass: default par "
          f"{o3['parfor']['pass_s']:.4f}, par=8 {o3['par=8']['pass_s']:.4f}, "
          f"par=1 {o3['par=1']['pass_s']:.4f}, "
          f"for {o3['for']['seconds'] / max(1, o3['parfor']['passes']):.4f}"
          f" (its run over the parfor run's passes); on {smi}", flush=True)
    return out


def univar_phase(data, dev, kernels, smi) -> dict:
    """`[parfor-univar]`: Univar-Stats.dml with K all 2 over the Census
    codes (1..d_j, fp32): the parfor over the 68 columns, each a
    table(col, 1); rows 15-17 against numpy's bincount of the host copy,
    row 15 against the drawn dims, and the 17 x 68 matrix bit-identical
    to the same script with a for loop."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml

    codes = data["codes"]
    xc = codes.to(torch.float32) + 1
    k = torch.full((1, CENSUS_M), 2.0, device=dev)
    host = codes.cpu().numpy()
    runs = {}
    for loop in ("", "par=8", "for"):
        ml = MLContext()
        ml.printer = lambda s: None
        script = (dml(_loop_variant("Univar-Stats.dml", UNIVAR_PARFOR, loop))
                  .input("X", xc).input("K", k).output("stats"))
        reset_launches(kernels)
        torch.cuda.synchronize()
        with ParforSpy() as spy:
            t0 = time.perf_counter()
            st = ml.execute(script).get_tensor("stats")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        runs[loop or "parfor"] = {
            "out": st, "ms": 1e3 * secs,
            "parfor_ms": (1e3 * sum(t1 - t0 for t0, t1, _ in spy.calls)
                          if spy.calls else None),
            "plan": (spy.calls[0][2].describe() if spy.calls else None),
            "merge_ms": spy.merge_ms[0] if spy.merge_ms else None,
            "launches": read_launches(kernels)}
    st = runs["parfor"]["out"].double().cpu().numpy()
    cats = np.array([np.bincount(host[:, j]).size for j in range(CENSUS_M)])
    modes = np.array([np.argmax(np.bincount(host[:, j])) + 1
                      for j in range(CENSUS_M)])
    nmodes = np.array([int((np.bincount(host[:, j])
                            == np.bincount(host[:, j]).max()).sum())
                       for j in range(CENSUS_M)])
    same = bool(torch.equal(runs["parfor"]["out"], runs["for"]["out"])
                and torch.equal(runs["par=8"]["out"], runs["for"]["out"]))
    ok = (np.array_equal(st[14], cats) and np.array_equal(st[15], modes)
          and np.array_equal(st[16], nmodes)
          and np.array_equal(st[14], np.array(data["dims"])))
    print(f"[parfor-univar] Univar-Stats over the Census codes ({CENSUS_N}, "
          f"{CENSUS_M}) fp32, K all 2: parfor {runs['parfor']['ms']:.1f} ms "
          f"(its window {runs['parfor']['parfor_ms']:.1f} ms, its merge "
          f"{runs['parfor']['merge_ms']:.2f} ms, plan "
          f"{runs['parfor']['plan']}), par=8 {runs['par=8']['ms']:.1f} ms "
          f"(its window {runs['par=8']['parfor_ms']:.1f} ms, plan "
          f"{runs['par=8']['plan']}), for {runs['for']['ms']:.1f} ms; rows "
          f"15-17 equal bincount's {ok}; 17 x {CENSUS_M} (default par and "
          f"par=8) bit-identical to the for run {same}; launches {runs['parfor']['launches']}; on "
          f"{smi}", flush=True)
    if not ok:
        fail("[parfor-univar] rows 15-17 differ from numpy's bincount or "
             "row 15 from the drawn dims")
    if not same:
        fail("[parfor-univar] the parfor's stats differ from the for run's")
    return {k: {kk: vv for kk, vv in r.items() if kk != "out"}
            for k, r in runs.items()}


def _write_census_csv(codes, path: str) -> None:
    """The codes' rows as a csv frame with a header: column j's tokens
    are "c1".."c8" (two bytes each), built as one byte array."""
    n, m = codes.shape
    buf = np.full((n, 3 * m), ord(","), dtype=np.uint8)
    buf[:, 0::3] = ord("c")
    buf[:, 1::3] = ord("1") + codes
    buf[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write((",".join(f"C{j + 1}" for j in range(m)) + "\n").encode())
        f.write(buf.tobytes())


def transform_phase(data, dev, smi) -> dict:
    """`[transform]`: transform.dml, then apply-transform.dml, by the CLI
    (api/cli.main, what `python -m systemml_tpu_torch` runs) on the card
    in this process, over a csv frame with a header of the Census codes'
    first TRANSFORM_ROWS rows; the spec recodes all 68 columns and
    dummycodes TRANSFORM_DUMMY. The same two runs on the CPU by `python -m
    systemml_tpu_torch` subprocesses beside them. Apply's X equals
    encode's bit for bit and both equal the CPU's; encode's X was on the
    card when written."""
    import contextlib
    import io
    import shutil
    import tempfile

    from systemml_tpu_torch.api import cli
    from systemml_tpu_torch.io import matrixio
    from systemml_tpu_torch.utils.config import get_config, set_config

    codes = data["codes"][:TRANSFORM_ROWS].cpu().numpy()
    d = tempfile.mkdtemp(prefix="smtorch-tf-")
    written = []
    orig_write = matrixio.write_matrix

    def spy_write(m, path, *args, **kwargs):
        written.append((path, m.array.device.type))
        return orig_write(m, path, *args, **kwargs)

    try:
        csv, spec = os.path.join(d, "data.csv"), os.path.join(d, "spec.json")
        t0 = time.perf_counter()
        _write_census_csv(codes, csv)
        names = [f"C{j + 1}" for j in range(CENSUS_M)]
        with open(spec, "w") as f:
            json.dump({"recode": names,
                       "dummycode": names[:TRANSFORM_DUMMY]}, f)
        write_s = time.perf_counter() - t0
        cpu_cfg = os.path.join(d, "cpu.json")
        with open(cpu_cfg, "w") as f:
            json.dump({"device": "cpu"}, f)

        def argv(script, tag, extra=()):
            return ["-f", os.path.join(ALG, script), "-stats", *extra,
                    "-nvargs", f"DATA={csv}", f"TFSPEC={spec}",
                    f"TFMTD={os.path.join(d, tag, 'meta')}",
                    f"OUTPUT={os.path.join(d, tag, script + '.csv')}"]

        outs, hh = {}, {}
        for script in ("transform.dml", "apply-transform.dml"):
            sub = subprocess.Popen(
                [sys.executable, "-m", "systemml_tpu_torch",
                 *argv(script, "cpu", ("-config", cpu_cfg))], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            buf = io.StringIO()
            matrixio.write_matrix = spy_write
            old_cfg = get_config()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(argv(script, "card"))
            finally:
                matrixio.write_matrix = orig_write
                set_config(old_cfg)
            card_s = time.perf_counter() - t0
            sout, serr = sub.communicate(timeout=600)
            if rc != 0 or sub.returncode != 0:
                fail(f"[transform] {script}: card rc {rc}, CPU rc "
                     f"{sub.returncode}: {serr[-2000:]}")
            times = {}
            for ln in buf.getvalue().splitlines():
                if ln.startswith("  ") and "\t" in ln and "Time(s)" not in ln:
                    parts = ln.strip().split("\t")
                    times[parts[0].split(None, 1)[-1]] = float(parts[1])
            hh[script] = {"wall_s": card_s, "read_s": times.get("call:read"),
                          "encode_s": times.get("call:transformencode"),
                          "apply_s": times.get("call:transformapply")}
            for tag in ("card", "cpu"):
                outs[(script, tag)] = torch.from_numpy(matrixio.read_matrix(
                    os.path.join(d, tag, script + ".csv"), "csv").to_numpy())
        enc, app = outs[("transform.dml", "card")], \
            outs[("apply-transform.dml", "card")]
        same = bool(torch.equal(enc, app))
        cpu_same = bool(torch.equal(enc, outs[("transform.dml", "cpu")])
                        and torch.equal(app,
                                        outs[("apply-transform.dml", "cpu")]))
        on_card = [dt for p, dt in written
                   if os.path.basename(p) == "transform.dml.csv"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    width = CENSUS_M - TRANSFORM_DUMMY + sum(data["dims"][:TRANSFORM_DUMMY])
    print(f"[transform] transform.dml then apply-transform.dml by the CLI "
          f"over a ({TRANSFORM_ROWS}, {CENSUS_M}) csv frame of category "
          f"tokens (the Census codes' first rows), {CENSUS_M} recoded, "
          f"{TRANSFORM_DUMMY} dummycoded: X {tuple(enc.shape)} (expected "
          f"width {width}); host s: csv written {write_s:.2f}, encode run "
          f"{hh['transform.dml']['wall_s']:.2f} (frame read "
          f"{hh['transform.dml']['read_s']}, transformencode "
          f"{hh['transform.dml']['encode_s']}), apply run "
          f"{hh['apply-transform.dml']['wall_s']:.2f} (frame read "
          f"{hh['apply-transform.dml']['read_s']}, transformapply "
          f"{hh['apply-transform.dml']['apply_s']}); apply's X equals "
          f"encode's {same}; both equal the CPU's {cpu_same}; encode's X "
          f"written from {on_card}; on {smi}", flush=True)
    if not same or not cpu_same or on_card != ["cuda"] \
            or tuple(enc.shape) != (TRANSFORM_ROWS, width):
        fail("[transform] apply's X differs from encode's, or from the "
             "CPU's, or the encoded X was not on the card, or its shape is "
             "wrong")
    return {"rows": TRANSFORM_ROWS, "cols": CENSUS_M,
            "x_shape": list(enc.shape), "csv_write_s": write_s,
            "host_s": hh, "apply_equals_encode": same,
            "equals_cpu": cpu_same}


def _stats_line(text: str, head: str) -> str:
    return next((ln for ln in text.splitlines() if ln.startswith(head)), "")


def _stats_counts(line: str) -> dict:
    body = line.split(":", 1)[1] if ":" in line else ""
    out = {}
    for part in body.split(","):
        if "=" in part:
            k, v = part.strip().rsplit("=", 1)
            try:
                out[k.split("(")[-1].strip()] = int(v)
            except ValueError:
                pass
    return out


def cli_phase(data, beta_mlc, mlc_mmchain, dev) -> dict:
    """`[cli]`: X written by the port's writer as a binary block and y as
    csv, each with its .mtd, into a fresh temporary directory; LinearRegCG.dml
    run by `python -m systemml_tpu_torch -stats` over them as a subprocess;
    B read back and held to beta_true and to the MLContext run; K1 as many
    times as the MLContext run, and the read's native arm."""
    import shutil
    import tempfile

    from systemml_tpu_torch.io import binaryblock, matrixio
    from systemml_tpu_torch.runtime.data import MatrixObject

    x, y = data["X"], data["y"]
    x_bytes = x.numel() * x.element_size()
    d = tempfile.mkdtemp(prefix="smtorch-cli-")
    try:
        free = shutil.disk_usage(d).free
        print(f"[cli] free disk bytes in {d}: {free} (X {x_bytes})",
              flush=True)
        if free < 1.2 * x_bytes:
            fail(f"[cli] {free} free bytes cannot hold X's {x_bytes}")
        px, py, pb = (os.path.join(d, n) for n in ("X.bb", "y.csv", "B"))
        binaryblock.ARM_COUNTS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        matrixio.write_matrix(MatrixObject(x, nnz=x.numel()), px,
                              "binary_block")
        write_s = time.perf_counter() - t0
        matrixio.write_matrix(MatrixObject(y, nnz=y.numel()), py, "csv")
        # the read alone, in this process: pinned host memory, one copy
        t0 = time.perf_counter()
        back = binaryblock.read_tensor(px, dev, torch.float32)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        same = bool(torch.equal(back, x))
        del back
        torch.cuda.empty_cache()
        arms = dict(binaryblock.ARM_COUNTS)
        if not same or arms.get(("read", "native")) != 1 \
                or arms.get(("write", "native")) != 1:
            fail(f"[cli] the binary block read back differs ({same}) or "
                 f"an arm was not native: {arms}")
        cmd = [sys.executable, "-m", "systemml_tpu_torch", "-f",
               os.path.join(ALG, "LinearRegCG.dml"), "-stats", "-nvargs",
               f"X={px}", f"Y={py}", f"B={pb}", "fmt=binary", "maxi=20",
               "tol=1e-9", "reg=1e-6"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        wall_s = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"[cli] the CLI exited {r.returncode}: {r.stderr[-3000:]}")
        out = r.stdout
        b = torch.from_numpy(np.load(pb)).to(dev)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    bt = data["beta_true"].double()
    rel_true = float(torch.linalg.norm(b.double() - bt) / torch.linalg.norm(bt))
    rel_mlc = float(torch.linalg.norm(b.double() - beta_mlc.double())
                    / torch.linalg.norm(beta_mlc.double()))
    launches = _stats_counts(_stats_line(out, "Kernel launches"))
    decisions = _stats_counts(_stats_line(out, "Optimizer decisions"))
    iters = int(_stats_line(out, "LinearRegCG: iterations = ").split(
        "= ")[1].split(",")[0])
    exec_s = float(_stats_line(out, "Total execution time").split()[-2])
    compile_s = float(_stats_line(out, "Parse and compile time").split()[-2])
    hh = [ln.strip() for ln in out.splitlines()
          if ln.startswith("  ") and "\t" in ln and "Time(s)" not in ln]
    hh_time = {}
    for ln in hh:
        parts = ln.split("\t")
        hh_time[parts[0].split(None, 1)[-1]] = float(parts[1])
    io_s = hh_time.get("call:read", 0.0) + hh_time.get("call:write", 0.0)
    iter_ms = 1e3 * (exec_s - io_s) / max(iters, 1)
    rec = {"write_gb_s": x_bytes / write_s / 1e9,
           "read_gb_s": x_bytes / read_s / 1e9,
           "cli_read_s": hh_time.get("call:read"), "wall_s": wall_s,
           "parse_compile_s": compile_s, "exec_s": exec_s,
           "iterations": iters, "iteration_ms": iter_ms,
           "beta_vs_true": rel_true, "beta_vs_mlcontext": rel_mlc,
           "mmchain": launches.get("mmchain", 0),
           "mmchain_mlcontext": mlc_mmchain,
           "io_read_native": decisions.get("io_read_native", 0),
           "heavy_hitters": hh}
    print(f"[cli] LinearRegCG.dml by python -m systemml_tpu_torch over a "
          f"{x_bytes / 1e9:.1f} GB binary-block X on {nvidia_smi_line()}: "
          f"write {rec['write_gb_s']:.2f} GB/s, read {rec['read_gb_s']:.2f} "
          f"GB/s (native, pinned, one copy to the card); the CLI's "
          f"call:read {rec['cli_read_s']} s; parse and compile "
          f"{compile_s:.3f} s of host time; {iters} CG iterations, "
          f"{iter_ms:.3f} ms per iteration (execution less read and write); "
          f"|B - beta_true| / |beta_true| = {rel_true:.3e} (bar 1e-3), "
          f"|B - B(MLContext)| / |B(MLContext)| = {rel_mlc:.3e} (bar 1e-5); "
          f"mmchain {rec['mmchain']} launches against {mlc_mmchain} in the "
          f"MLContext run; native reads {rec['io_read_native']}; "
          f"{wall_s:.1f} s for the subprocess", flush=True)
    for ln in hh:
        print(f"[cli] heavy hitter {ln}")
    if not rel_true <= 1e-3 or not rel_mlc <= 1e-5:
        fail(f"[cli] B is {rel_true} from beta_true or {rel_mlc} from the "
             f"MLContext run")
    if rec["mmchain"] != mlc_mmchain or mlc_mmchain < 1:
        fail(f"[cli] mmchain launched {rec['mmchain']} times, the MLContext "
             f"run {mlc_mmchain}")
    if rec["io_read_native"] < 2:
        fail(f"[cli] the reads did not take the native arm: {decisions}")
    return rec


def pool_phase(data, dev) -> dict:
    """`[pool]`: POOL_SCRIPT with the pool off, whose peak over the data
    is what A, B and C hold live together (at least twice POOL_BUDGET),
    and under POOL_BUDGET: results bit for bit, evictions and restores
    above 0, and the pool's peak within the budget plus the working set
    of the largest block (POOL_WORKING_SCRIPT's peak with the pool off),
    a bound the run without the pool must exceed."""
    import gc

    from systemml_tpu_torch.api.mlcontext import MLContext, dml

    x = data["X"]

    def run(src, outs, enabled):
        cfg = config(2)
        cfg.bufferpool_enabled = enabled
        cfg.bufferpool_budget_bytes = POOL_BUDGET
        ml = MLContext(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = ml.execute(dml(src).input("X", x).output(*outs))
        vals = {k: float(res.get_scalar(k)) for k in outs}
        torch.cuda.synchronize()
        rec = {"values": vals, "seconds": time.perf_counter() - t0,
               "peak_over_data": torch.cuda.max_memory_allocated(dev) - base,
               "pool": dict(ml._stats.pool_counts.items())}
        del res, ml
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    working = run(POOL_WORKING_SCRIPT, ("s1",), False)["peak_over_data"]
    runs = {"off": run(POOL_SCRIPT, POOL_OUTPUTS, False),
            "pool": run(POOL_SCRIPT, POOL_OUTPUTS, True)}
    p, o = runs["pool"], runs["off"]
    bound = POOL_BUDGET + working
    print(f"[pool] {len(p['values'])} results with the pool (budget "
          f"{POOL_BUDGET / 1e9:.0f} GB) equal to the pool off bit for bit: "
          f"{p['values'] == o['values']}; pool events {p['pool']}; peak "
          f"over the data without the pool (A, B and C live) "
          f"{o['peak_over_data'] / 1e9:.3f} GB, with it "
          f"{p['peak_over_data'] / 1e9:.3f} GB (bound: budget + the largest "
          f"block's working set, measured {working / 1e9:.3f} GB, = "
          f"{bound / 1e9:.3f} GB); {p['seconds']:.2f} s / "
          f"{o['seconds']:.2f} s on {nvidia_smi_line()}", flush=True)
    if p["values"] != o["values"]:
        fail(f"[pool] results differ: {p['values']} against {o['values']}")
    if not (p["pool"].get("evict", 0) > 0 and p["pool"].get("restore", 0) > 0):
        fail(f"[pool] no eviction or no restore: {p['pool']}")
    if o["peak_over_data"] < 2 * POOL_BUDGET:
        fail(f"[pool] the live matrices peak at {o['peak_over_data']}, "
             f"below twice the budget {POOL_BUDGET}")
    if p["peak_over_data"] > bound or o["peak_over_data"] <= bound:
        fail(f"[pool] peak {p['peak_over_data']} with the pool, "
             f"{o['peak_over_data']} without, against budget + working "
             f"set {bound}")
    runs["working_set"] = working
    return runs


def block_phase(breadth, paths_launches) -> dict:
    """`[block]`: Kmeans's run at optlevel 3 from the breadth phase through
    the block compile: its peak over the data (below 2.5 GB: `X ^ 2` is
    not formed), blocks planned, eager blocks by reason, K2 and K4; and
    the K2 and K4 totals over the earlier paths."""
    km = breadth["Kmeans"]["optlevel3"]
    blocks = km["blocks"]
    k2 = sum(c["spoof_cell"] for c in paths_launches.values())
    k4 = sum(c["spoof_row"] for c in paths_launches.values())
    reasons = blocks["eager_by_reason"] or "none outside a region"
    print(f"[block] Kmeans ({M} x {K} fp32) optlevel 3: peak allocated over "
          f"the data {km['peak_over_data'] / 1e9:.3f} GB (bar 2.5; PR 10 "
          f"8.0 with X ^ 2 formed); blocks {blocks['fused']} through their "
          f"plans, {blocks['eager']} eager (by reason: {reasons}), "
          f"{blocks['plans']} plans, "
          f"{blocks['block_spoof_plans']} fused plans the block compile "
          f"selected, graphs {blocks['graphs'] or 'none'}; K2 "
          f"{km['launches']['spoof_cell']}, K4 {km['launches']['spoof_row']};"
          f" over the paths K2 {k2}, K4 {k4} (PR 10: 338, 2,009)",
          flush=True)
    if km["peak_over_data"] >= 2.5e9:
        fail(f"[block] Kmeans's peak over the data {km['peak_over_data']} "
             f">= 2.5 GB")
    if blocks["block_spoof_plans"] < 1:
        fail("[block] the block compile selected no plan for Kmeans")
    return {"kmeans_peak_over_data": km["peak_over_data"], "blocks": blocks,
            "k2_paths": k2, "k4_paths": k4}


def jmlc_phase(data, dev) -> dict:
    """`[jmlc]`: each of JMLC_SCRIPTS prepared once with graphs and once
    with codegen off (no graphs), and the two called in turn JMLC_CALLS
    times on 1,000-row batches of X: for the softmax scorer, calls
    through the plan watched for synchronizing calls until one is free
    of them, one capture, the rest graph launches; the product refused
    a graph as one op; each result against the run without graphs, and
    the host wall time a call of each (with a sync)."""
    from systemml_tpu_torch.api.jmlc import Connection

    x = data["X"]
    gen = torch.Generator(device=dev).manual_seed(13)
    consts = {"B": data["beta_true"],
              "W": torch.randn(K, 10, generator=gen, device=dev),
              "b": torch.randn(1, 10, generator=gen, device=dev)}
    cfg_off = config(2)
    cfg_off.codegen_enabled = False
    out = {}
    for label, (src, names, graphed) in JMLC_SCRIPTS.items():
        ps = Connection(config(2)).prepare_script(
            src, input_names=["X"] + names, output_names=["yhat"])
        ref_ps = Connection(cfg_off).prepare_script(
            src, input_names=["X"] + names, output_names=["yhat"])
        times, ref_times, worst, bitwise = [], [], 0.0, True
        for i in range(JMLC_CALLS):
            bind = {"X": x[i * JMLC_BATCH:(i + 1) * JMLC_BATCH],
                    **{n: consts[n] for n in names}}
            got = {}
            for arm, p, ts in (("graph", ps, times),
                               ("plain", ref_ps, ref_times)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[arm] = p.execute(bind).get_tensor("yhat")
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
            y, ref = got["graph"], got["plain"]
            bitwise = bitwise and bool(torch.equal(y, ref))
            worst = max(worst, float(
                torch.linalg.norm(y.double() - ref.double())
                / torch.linalg.norm(ref.double())))
        g = dict(ps.stats.block_graph_counts.items())
        watched = g.get("watched", 0)
        # the calls after the capture (after the first without a graph)
        first = watched + 1 if graphed else 1
        rest = sorted(times[first:])
        ref_rest = sorted(ref_times[first:])
        rec = {"watched_ms": times[:watched],
               "capture_ms": times[watched] if graphed else None,
               "first_ms": times[0],
               "rest_median_ms": rest[len(rest) // 2], "rest_min_ms": rest[0],
               "plain_first_ms": ref_times[0],
               "plain_rest_median_ms": ref_rest[len(ref_rest) // 2],
               "plain_rest_min_ms": ref_rest[0],
               "graphs": g, "bit_identical": bitwise, "max_normwise": worst}
        out[label] = rec
        head = (f"{watched} watched calls through the plan "
                f"{[round(t, 3) for t in times[:watched]]} ms, the capture "
                f"call {times[watched]:.3f} ms" if graphed else
                f"no graph (one op), first call {times[0]:.3f} ms")
        print(f"[jmlc] {label} ({src!r}) on {JMLC_BATCH}-row batches, "
              f"{JMLC_CALLS} calls on {nvidia_smi_line()}: with graphs on, "
              f"{head}, the rest {rec['rest_median_ms']:.4f} ms median "
              f"({rest[0]:.4f} min) per call; without graphs first "
              f"{ref_times[0]:.3f} ms, the "
              f"same calls {rec['plain_rest_median_ms']:.4f} ms median "
              f"({ref_rest[0]:.4f} min); host wall with a sync; graphs {g}; "
              f"against the run without graphs bit-identical {bitwise}, "
              f"worst {worst:.3e}", flush=True)
        if graphed and (g.get("capture") != 1 or not 1 <= watched <= 2
                        or watched + g.get("replay", 0) != JMLC_CALLS):
            fail(f"[jmlc] {label}: graphs {g}: one or two watched calls, "
                 f"one capture, and a launch on every other call expected")
        if not graphed and g != {"nograph:one op": 1}:
            fail(f"[jmlc] {label}: graphs {g}, not one refusal (one op)")
        if worst > 1e-6:
            fail(f"[jmlc] {label}: results differ from the run without "
                 f"graphs: {worst}")
    return out


# --------------------------------------------------------------------------
# [serving]: the serving tier over the softmax scorer at 1,000 features
# --------------------------------------------------------------------------

SERVING_LADDER = (1, 8, 64, 512)
# a host copy of X's first rows: the requests are taken from it, as
# requests arrive from a user's host
SERVING_HOST_ROWS = 100_000
SERVING_CLASSES = 10
SERVING_CLIENTS, SERVING_REQUESTS = 16, 2_000
# one client alone first, for the host time of a request without
# contention; its second half under cProfile
SERVING_ALONE = 400
# the two requests beyond the ladder, mid-traffic, from two clients: the
# first opens rung 1,024 (a miss: its plan compiled, its run watched),
# the second captures its graph
SERVING_BEYOND = ((3, 60, 700), (11, 80, 900))
MB_CLIENTS, MB_REQUESTS, MB_MAX, MB_DEADLINE_US = 64, 50, 64, 2_000
SERVING_BARS = {"torch": 1e-5, "exact": 1e-6}
SERVING_AUTO3_REASON = ("output 'yhat' is not row-decomposable (spoof: "
                        "row-mixing or unanalyzed op)")


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _srv_counts(stats) -> dict:
    return dict(stats.estim_counts.grouped()["serving"])


class _WaitClock:
    """Where a request's host wall goes under concurrent clients: seconds
    each thread waits for the block compile's locks (each warm plan's and
    each captured graph's lock wrapped, so a graph captured later is not
    seen) and spends in the prepared script's host-to-card copy of the
    request, summed per thread since its last `take()`."""

    def __init__(self, prepared):
        from systemml_tpu_torch.runtime.program import iter_basic_blocks

        self._tls = threading.local()
        for blk in iter_basic_blocks(prepared._program):
            for plan in blk._plans.values():
                plan.lock = self._Timed(plan.lock, self._tls)
                for g in plan.graphs.values():
                    g.lock = self._Timed(g.lock, self._tls)
        unwrap = prepared._unwrap
        tls = self._tls

        def timed_unwrap(value):
            t0 = time.perf_counter()
            try:
                return unwrap(value)
            finally:
                tls.upload = getattr(tls, "upload", 0.0) \
                    + time.perf_counter() - t0

        prepared._unwrap = timed_unwrap

    class _Timed:
        def __init__(self, lock, tls):
            self._lock, self._tls = lock, tls

        def __enter__(self):
            t0 = time.perf_counter()
            self._lock.acquire()
            self._tls.wait = getattr(self._tls, "wait", 0.0) \
                + time.perf_counter() - t0
            return self

        def __exit__(self, *exc):
            self._lock.release()

    def take(self):
        """(lock wait s, upload s) of this thread since its last take."""
        got = (getattr(self._tls, "wait", 0.0),
               getattr(self._tls, "upload", 0.0))
        self._tls.wait = self._tls.upload = 0.0
        return got


def _breakdown(parts) -> dict:
    """Per-request ms (median and mean) of each part of a list of
    per-request dicts of seconds, and each part's share of the summed
    wall."""
    wall = sum(p["wall"] for p in parts)
    out = {}
    for k in parts[0]:
        xs = [p[k] for p in parts]
        out[k] = {"p50_ms": 1e3 * _pct(xs, 0.5),
                  "mean_ms": 1e3 * sum(xs) / len(xs),
                  "share_of_wall": sum(xs) / wall}
    return out


def serving_phase(data, dev, kernels, smi) -> dict:
    """`[serving]`: the softmax scorer (JMLC_SCRIPTS' second) over X's
    1,000 features and 10 classes, prepared once at optlevel 3 (one row
    plan: K4) and served by a ScoringService with validate "force" on the
    ladder 1/8/64/512: warmup(1000), then SERVING_CLIENTS threads sending
    SERVING_REQUESTS requests of log-uniform 1-512 rows of a host copy of
    X's first rows (two beyond the ladder, SERVING_BEYOND), then
    MB_CLIENTS threads of MB_REQUESTS single-row requests through a
    MicroBatcher; the launch counters set to 0 just before the traffic
    and read just after. Checks (each fails the run): "auto" refused at
    optlevel 3 with the JAX package's reason and proven at optlevel 2
    (rows, batchable); every answer within 1e-5 normwise of torch's
    softmax on the card and within 1e-6 of the same rows at their exact
    shape with validate "off" and codegen off; after warmup no plan
    compile, capture or nvcc build but rung 1,024's; K4 launches equal
    to the optlevel-3 dispatches; the statistics' srv_* counters equal
    to the registry's; one scrape of /metrics on loopback with
    requests_total equal to the requests served. K4 against its plain
    version at the scorer's plan and the largest rung's shape, timed.
    Each request of the direct traffic and of the client alone is broken
    down (_WaitClock): in score(), the host-to-card copy, the wait for the
    block compile's locks, the thread's CPU time and the rest (off the
    CPU: the GIL, the card's copies); and the answer's copy to the host,
    which waits for what the clients queued on the shared stream."""
    import urllib.request

    from systemml_tpu_torch.api.jmlc import Connection
    from systemml_tpu_torch.api.serving import MicroBatcher, ScoringService
    from systemml_tpu_torch.codegen import build
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    t_phase = time.perf_counter()
    src = JMLC_SCRIPTS["softmax"][0]
    host = data["X"][:SERVING_HOST_ROWS].cpu().numpy()
    rng = np.random.default_rng(15)
    w = (rng.standard_normal((K, SERVING_CLASSES)) / math.sqrt(K)).astype(
        np.float32)
    b = rng.standard_normal((1, SERVING_CLASSES)).astype(np.float32)
    consts = {"W": w, "b": b}
    meta = {"X": {"shape": (None, K)}, "W": {"shape": (K, SERVING_CLASSES)},
            "b": {"shape": (1, SERVING_CLASSES)}}
    names = dict(input_names=["X", "W", "b"], output_names=["yhat"],
                 input_meta=meta)
    w_dev, b_dev = torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)

    # the proof: refused at optlevel 3 (a fused plan), held at 2
    ps3 = Connection(config(3)).prepare_script(src, **names)
    auto3 = ScoringService(ps3, constants=consts)
    auto2 = ScoringService(Connection(config(2)).prepare_script(src, **names),
                           constants=consts)
    rows = [h for h in iter_spoof_hops(ps3._program)
            if h.params["template"] == "row"]
    print(f"[serving] proof: optlevel 2 bucketing "
          f"{auto2.bucketing_enabled}, batchable {auto2.batchable}, out "
          f"classes {auto2._out_classes}; optlevel 3 bucketing "
          f"{auto3.bucketing_enabled} ({auto3.safety_reason!r}); the "
          f"scorer's fused plans at optlevel 3: "
          f"{[h.params['plan'].pretty() for h in rows]}", flush=True)
    if not (auto2.bucketing_enabled and auto2.batchable
            and auto2._out_classes == {"yhat": "rows"}):
        fail(f"[serving] optlevel 2: the proof refused: "
             f"{auto2.safety_reason!r}")
    if auto3.bucketing_enabled or auto3.safety_reason != SERVING_AUTO3_REASON:
        fail(f"[serving] optlevel 3 'auto': {auto3.bucketing_enabled}, "
             f"{auto3.safety_reason!r}, not {SERVING_AUTO3_REASON!r}")
    if len(rows) != 1:
        fail(f"[serving] the scorer at optlevel 3 has {len(rows)} row plans, "
             f"not one")
    del auto3, auto2

    svc = ScoringService(ps3, constants=consts, ladder=SERVING_LADDER,
                         validate="force")
    ref_cfg = config(2, regions=False)
    ref = ScoringService(Connection(ref_cfg).prepare_script(src, **names),
                         constants=consts, validate="off")
    t0 = time.perf_counter()
    warmed = svc.warmup(K)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    st = ps3.stats
    g_warm = dict(st.block_graph_counts.items())
    after_warmup = {"compiles": st.compile_count,
                    "captures": g_warm.get("capture", 0),
                    "builds": len(build.build_reports),
                    "requests": svc.registry.get("requests_total").value}
    print(f"[serving] warmup of rungs {warmed} on {smi}: {warmup_s:.2f} s, "
          f"plans {st.compile_count}, block graphs {g_warm}", flush=True)
    if g_warm.get("capture", 0) != len(SERVING_LADDER):
        fail(f"[serving] warmup: {g_warm}, not one capture per rung")
    endpoint = svc.serve_metrics(port=0)
    clock = _WaitClock(ps3)

    def timed_request(x):
        """One request's answer on the host and its parts in seconds."""
        clock.take()
        t1, c1 = time.perf_counter(), time.thread_time()
        y = svc.score(x)["yhat"]
        t2, c2 = time.perf_counter(), time.thread_time()
        y = y.cpu()
        t3 = time.perf_counter()
        wait, upload = clock.take()
        return y, {"wall": t3 - t1, "score": t2 - t1, "upload": upload,
                   "lock_wait": wait, "score_cpu": c2 - c1,
                   "score_off_cpu": max(0.0, (t2 - t1) - (c2 - c1) - wait),
                   "to_host": t3 - t2}

    def log_uniform(count):
        n = np.exp(rng.uniform(0.0, math.log(SERVING_LADDER[-1]), count))
        return np.clip(n.astype(np.int64), 1, SERVING_LADDER[-1])

    # one client alone: the host time of a request without contention
    import cProfile
    import pstats

    alone = [(int(rng.integers(0, SERVING_HOST_ROWS - n + 1)), int(n))
             for n in log_uniform(SERVING_ALONE)]
    alone_answers, alone_lat, alone_parts = [], [], []
    for r0, n in alone[:10]:   # untimed: the client's first calls
        svc.score(host[r0:r0 + n])["yhat"].cpu()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    for i, (r0, n) in enumerate(alone):
        if i == SERVING_ALONE // 2:
            alone_s = time.perf_counter() - t0
            prof.enable()
        y, parts = timed_request(host[r0:r0 + n])
        alone_answers.append(y)
        alone_lat.append(parts["wall"])
        if i < SERVING_ALONE // 2:
            alone_parts.append(parts)
    prof.disable()
    alone_rows = sum(n for _, n in alone[:SERVING_ALONE // 2])
    top = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: -kv[1][2])[:10]
    alone_top = [{"function": f"{os.path.basename(f)}:{ln}({fn})",
                  "calls": v[1], "tottime_ms_per_request":
                      1e3 * v[2] / (SERVING_ALONE // 2)}
                 for (f, ln, fn), v in top]
    before_direct = svc.registry.get("requests_total").value

    # direct traffic: SERVING_CLIENTS clients, log-uniform sizes
    sizes = log_uniform(SERVING_REQUESTS)
    per = SERVING_REQUESTS // SERVING_CLIENTS
    plan = [[int(n) for n in sizes[c * per:(c + 1) * per]]
            for c in range(SERVING_CLIENTS)]
    for c, i, n in SERVING_BEYOND:
        plan[c][i] = n
    starts = [[int(rng.integers(0, SERVING_HOST_ROWS - n + 1)) for n in ns]
              for ns in plan]
    answers = [[None] * per for _ in range(SERVING_CLIENTS)]
    lat = [[0.0] * per for _ in range(SERVING_CLIENTS)]
    d_parts = [[None] * per for _ in range(SERVING_CLIENTS)]
    errors = []
    barrier = threading.Barrier(SERVING_CLIENTS)

    def direct(c):
        try:
            barrier.wait()
            for i, n in enumerate(plan[c]):
                s0 = starts[c][i]
                answers[c][i], d_parts[c][i] = timed_request(
                    host[s0:s0 + n])
                lat[c][i] = d_parts[c][i]["wall"]
        except Exception as e:  # the run fails on it below
            errors.append(repr(e))

    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    ts = [threading.Thread(target=direct, args=(c,))
          for c in range(SERVING_CLIENTS)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    direct_s = time.perf_counter() - t0
    if errors:
        fail(f"[serving] direct traffic raised: {errors[:3]}")
    direct_requests = sum(len(p) for p in plan)
    direct_rows = sum(sum(p) for p in plan)
    d_lat = [x for row in lat for x in row]

    # coalesced traffic: MB_CLIENTS clients of single rows
    mb_rows = rng.integers(0, SERVING_HOST_ROWS, (MB_CLIENTS, MB_REQUESTS))
    mb_answers = [[None] * MB_REQUESTS for _ in range(MB_CLIENTS)]
    mb_lat = [[0.0] * MB_REQUESTS for _ in range(MB_CLIENTS)]
    before_mb = _srv_counts(st)
    barrier = threading.Barrier(MB_CLIENTS)
    with MicroBatcher(svc, max_batch=MB_MAX,
                      deadline_us=MB_DEADLINE_US) as mb:
        def coalesced(c):
            try:
                barrier.wait()
                for i in range(MB_REQUESTS):
                    r0 = int(mb_rows[c, i])
                    t1 = time.perf_counter()
                    mb_answers[c][i] = mb.score(host[r0:r0 + 1])
                    mb_lat[c][i] = time.perf_counter() - t1
            except Exception as e:  # the run fails on it below
                errors.append(repr(e))

        t0 = time.perf_counter()
        ts = [threading.Thread(target=coalesced, args=(c,))
              for c in range(MB_CLIENTS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        mb_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    if errors:
        fail(f"[serving] coalesced traffic raised: {errors[:3]}")
    with urllib.request.urlopen(endpoint.url, timeout=30) as resp:
        scraped = resp.read().decode("utf-8")
    endpoint.close()
    srv = _srv_counts(st)
    mb_counts = {k: srv.get(k, 0) - before_mb.get(k, 0) for k in
                 ("microbatch_flush", "microbatch_flush_size",
                  "microbatch_flush_deadline", "microbatched_requests")}
    flushes = mb_counts["microbatch_flush"]
    g = dict(st.block_graph_counts.items())
    reg = svc.registry
    served = reg.get("requests_total").value
    dispatches = served - before_direct
    scraped_total = [float(ln.split()[-1]) for ln in scraped.splitlines()
                     if ln.startswith("smtpu_serving_requests_total")]

    # every answer against torch on the card and the exact-shape run
    worst = {"torch": 0.0, "exact": 0.0}

    def hold(r0, n, y):
        xs = data["X"][r0:r0 + n]
        ref_t = torch.softmax(xs.double() @ w_dev.double()
                              + b_dev.double(), dim=1)
        got = y.to(dev).double()
        worst["torch"] = max(worst["torch"], normwise(got, ref_t))
        exact = ref.score(host[r0:r0 + n])["yhat"].double()
        worst["exact"] = max(worst["exact"], normwise(got, exact))
        if tuple(y.shape) != (n, SERVING_CLASSES):
            fail(f"[serving] an answer of shape {tuple(y.shape)} for {n} "
                 f"rows")

    for (r0, n), y in zip(alone, alone_answers):
        hold(r0, n, y)
    for c in range(SERVING_CLIENTS):
        for i, n in enumerate(plan[c]):
            hold(starts[c][i], n, answers[c][i])
    for c in range(MB_CLIENTS):
        for i in range(MB_REQUESTS):
            hold(int(mb_rows[c, i]), 1, torch.from_numpy(mb_answers[c][i]))

    # K4 at the scorer's plan and the largest warm rung's shape
    hop = rows[0]
    leaf = list(hop.params["leaf_names"])
    m = SERVING_LADDER[-1]
    gen = torch.Generator(device=dev).manual_seed(17)
    z = torch.randn(m, SERVING_CLASSES, generator=gen, device=dev)
    bias = torch.randn(1, SERVING_CLASSES, generator=gen, device=dev)
    env = dict(zip(leaf, (z, bias, (z + bias).amax(dim=1, keepdim=True))))
    agg = hop.params["row_agg"]
    got = kernels.row_kernel(hop.params["plan"], leaf, agg, env)
    plain = kernels.row_plain(hop.params["plan"], leaf, agg,
                              {k: v.double() for k, v in env.items()})
    k4_err = normwise(got, plain)
    k4_abs = float((got.double() - plain).abs().max())
    k4_ms = device_ms(lambda: kernels.row_kernel(hop.params["plan"], leaf,
                                                 agg, env), cold=True)
    k4_plain_ms = device_ms(lambda: kernels.row_plain(hop.params["plan"],
                                                      leaf, agg, env))
    k4_bound, k4_by = spoof_bound(hop.params["plan"], env, 4 * m,
                                  m * SERVING_CLASSES)
    # the rows of every bucketed dispatch, warmup's included: rung x count
    dispatched_rows = sum(v * int(k[k.index("[") + 1:-1])
                          for k, v in srv.items()
                          if k.startswith(("bucket_hit[", "bucket_miss[")))
    rec = {
        "warmup_s": warmup_s, "warmed": warmed, "after_warmup": after_warmup,
        "alone": {"requests": SERVING_ALONE // 2, "rows": alone_rows,
                  "seconds": alone_s,
                  "p50_ms": 1e3 * _pct(alone_lat[:SERVING_ALONE // 2], 0.5),
                  "p99_ms": 1e3 * _pct(alone_lat[:SERVING_ALONE // 2], 0.99),
                  "requests_per_s": SERVING_ALONE // 2 / alone_s,
                  "breakdown": _breakdown(alone_parts),
                  "profiled_ms_per_request":
                      1e3 * sum(alone_lat[SERVING_ALONE // 2:])
                      / (SERVING_ALONE // 2),
                  "top_tottime": alone_top},
        "direct": {"requests": direct_requests, "rows": direct_rows,
                   "seconds": direct_s, "p50_ms": 1e3 * _pct(d_lat, 0.5),
                   "p99_ms": 1e3 * _pct(d_lat, 0.99),
                   "requests_per_s": direct_requests / direct_s,
                   "breakdown": _breakdown(
                       [p for row in d_parts for p in row]),
                   "rows_per_s": direct_rows / direct_s},
        "coalesced": {"requests": MB_CLIENTS * MB_REQUESTS, "seconds": mb_s,
                      "p50_ms": 1e3 * _pct(sum(mb_lat, []), 0.5),
                      "p99_ms": 1e3 * _pct(sum(mb_lat, []), 0.99),
                      "requests_per_s": MB_CLIENTS * MB_REQUESTS / mb_s,
                      "flushes": flushes,
                      "requests_per_flush":
                          mb_counts["microbatched_requests"] / max(1, flushes),
                      "by_cause": {"size": mb_counts["microbatch_flush_size"],
                                   "deadline":
                                       mb_counts["microbatch_flush_deadline"]}},
        "block_graphs": g, "serving_counters": srv,
        "pad_share": srv.get("pad_rows", 0) / max(1, dispatched_rows),
        "launches": launches, "dispatches": dispatches, "served": served,
        "scraped_requests_total": scraped_total,
        "max_normwise": worst, "k4_serving": {
            "shape": [m, SERVING_CLASSES], "max_normwise": k4_err,
            "max_abs_err": k4_abs, "ms": k4_ms, "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound, "bound_by": k4_by},
        "seconds": time.perf_counter() - t_phase}
    d, c, a = rec["direct"], rec["coalesced"], rec["alone"]
    print(f"[serving] one client alone on {smi}: {a['requests']} requests "
          f"({a['rows']} rows) in {a['seconds']:.3f} s: p50 "
          f"{a['p50_ms']:.3f} ms, p99 {a['p99_ms']:.3f} ms, "
          f"{a['requests_per_s']:.1f} requests/s; under cProfile "
          f"{a['profiled_ms_per_request']:.3f} ms a request, the most "
          f"host time (ms a request): " + ", ".join(
              f"{t['function']} {t['tottime_ms_per_request']:.4f}"
              for t in alone_top), flush=True)
    print(f"[serving] direct on {smi}: {d['requests']} requests "
          f"({d['rows']} rows) from {SERVING_CLIENTS} clients in "
          f"{direct_s:.3f} s: per request p50 {d['p50_ms']:.3f} ms, p99 "
          f"{d['p99_ms']:.3f} ms (host wall, answer on the host), "
          f"{d['requests_per_s']:.1f} requests/s, {d['rows_per_s']:.0f} "
          f"rows/s", flush=True)
    for who, part in (("one client alone", a), (f"{SERVING_CLIENTS} "
                                                  "direct clients", d)):
        print(f"[serving] where a request's host wall goes, {who}, on "
              f"{smi} (p50 ms / mean ms / share of the summed wall): "
              + "; ".join(f"{k} {v['p50_ms']:.4f} / {v['mean_ms']:.4f} / "
                          f"{v['share_of_wall']:.3f}"
                          for k, v in part["breakdown"].items()),
              flush=True)
    print(f"[serving] coalesced on {smi}: {c['requests']} single-row "
          f"requests from {MB_CLIENTS} clients in {mb_s:.3f} s: p50 "
          f"{c['p50_ms']:.3f} ms, p99 {c['p99_ms']:.3f} ms, "
          f"{c['requests_per_s']:.1f} requests/s; {flushes} flushes, "
          f"{c['requests_per_flush']:.2f} requests per flush, by cause "
          f"{c['by_cause']}", flush=True)
    print(f"[serving] block graphs {g} (captures and launches, warmup "
          f"included); pad rows {rec['pad_share']:.4f} of the rows "
          f"dispatched; serving counters {srv}; launches in the traffic "
          f"{launches}; dispatches {dispatches}; requests served {served}, "
          f"scraped {scraped_total}; worst normwise against torch "
          f"{worst['torch']:.3e}, against the exact shape "
          f"{worst['exact']:.3e}; on {smi}", flush=True)
    print(f"[serving] K4 spoof_row {agg} at the scorer's plan "
          f"{hop.params['plan'].pretty()} ({m}, {SERVING_CLASSES}) fp32 on "
          f"{smi}: device time {k4_ms:.4f} ms with the L2 cache evicted, "
          f"plain {k4_plain_ms:.4f} ms, bound {k4_bound:.5f} ms ({k4_by}); "
          f"normwise {k4_err:.3e} against the plain version in fp64",
          flush=True)

    # the checks
    for key, bar in SERVING_BARS.items():
        if worst[key] > bar:
            fail(f"[serving] an answer {worst[key]:.3e} from the {key} "
                 f"reference (bar {bar})")
    if k4_err > SPOOF_BARS[torch.float32]:
        fail(f"[serving] K4 at the scorer's plan: {k4_err} from its plain "
             f"version")
    after = {"compiles": st.compile_count - after_warmup["compiles"],
             "captures": g.get("capture", 0) - after_warmup["captures"],
             "builds": len(build.build_reports) - after_warmup["builds"]}
    if after != {"compiles": 1, "captures": 1, "builds": 0}:
        fail(f"[serving] after warmup {after}: rung 1,024's plan compile "
             f"and capture only, and no build, expected")
    if launches["spoof_row"] != dispatches or any(
            v for k, v in launches.items() if k != "spoof_row"):
        fail(f"[serving] launches {launches} against {dispatches} "
             f"optlevel-3 dispatches: K4 once a dispatch, nothing else")
    if dispatches != direct_requests + flushes:
        fail(f"[serving] {dispatches} dispatches, not {direct_requests} "
             f"direct and {flushes} flushes")
    for kind in ("hit", "miss"):
        total = sum(v for k, v in srv.items()
                    if k.startswith(f"bucket_{kind}["))
        if total != reg.get(f"bucket_{kind}{'s' if kind == 'hit' else 'es'}"
                            "_total").value:
            fail(f"[serving] srv_bucket_{kind} {total} against the "
                 f"registry's")
    if srv.get("bucket_miss[1024]") != 1 or sum(
            v for k, v in srv.items() if k.startswith("bucket_miss[")) != \
            len(SERVING_LADDER) + 1:
        fail(f"[serving] misses {srv}: one per rung and rung 1,024's")
    if not (flushes == reg.get("microbatch_flushes_total").value
            == mb_counts["microbatch_flush_size"]
            + mb_counts["microbatch_flush_deadline"]
            and mb_counts["microbatched_requests"]
            == MB_CLIENTS * MB_REQUESTS):
        fail(f"[serving] flushes {mb_counts} against the registry's "
             f"{reg.get('microbatch_flushes_total').value}")
    if scraped_total != [float(served)]:
        fail(f"[serving] /metrics requests_total {scraped_total}, served "
             f"{served}")
    return rec


# --------------------------------------------------------------------------
# [fleet]: three replica processes behind a router (fleet/, obs/fleet.py)
# --------------------------------------------------------------------------

FLEET_REPLICAS, FLEET_CLIENTS = 3, 16
# each request: log-uniform 1-64 rows of the host copy of X's first rows
FLEET_MAX_ROWS = 64
# the first run: this many answered requests, and the last replica gone
FLEET_FIRST_REQUESTS = 1_000
# the last replica SIGKILLs itself once it has answered this many
FLEET_KILL_AFTER = 150
FLEET_AFTER_ROLLOUT_S = 1.0
# the overload run: each survivor admits this many requests at a time,
# while requests arrive open-loop at twice the first run's rate into a
# client pool of as many sender threads as the first run had clients (an
# arrival waits in the pool for a free sender; its deadline starts when
# it is sent). The router is one process whose JSON encoding bounds the
# first run: with 64 senders, 3 of 336 requests ran out their deadline
# inside it, waiting for its interpreter lock
FLEET_OVERLOAD_INFLIGHT, FLEET_OVERLOAD_S = 2, 4.0
FLEET_OVERLOAD_DEADLINE_S, FLEET_OVERLOAD_SENDERS = 2.0, FLEET_CLIENTS
# a served answer's wall, read by the client thread after submit returns,
# may pass the router's deadline by the thread's wake-up on a shared host
FLEET_DEADLINE_SLACK_S = 0.05
FLEET_HEARTBEAT_S = 0.2
FLEET_SEED = 19
FLEET_LIMIT_S = 480.0
# an answer against torch's softmax with its generation's W and b, and
# against the other generation's
FLEET_BAR, FLEET_GAP = 1e-5, 1e-3
FLEET_JSON_SAMPLES = 300


def fleet_weights(g: int):
    """Generation g's W (K, 10) and b (1, 10) fp32, from a generator seeded
    per generation: two generations' answers on the same rows are far
    apart, so an answer's value says which generation served it."""
    rng = np.random.default_rng(FLEET_SEED + g)
    w = (rng.standard_normal((K, SERVING_CLASSES)) / math.sqrt(K)).astype(
        np.float32)
    b = rng.standard_normal((1, SERVING_CLASSES)).astype(np.float32)
    return w, b


def _fleet_names():
    meta = {"X": {"shape": (None, K)}, "W": {"shape": (K, SERVING_CLASSES)},
            "b": {"shape": (1, SERVING_CLASSES)}}
    return dict(input_names=["X", "W", "b"], output_names=["yhat"],
                input_meta=meta)


def fleet_replica(rank: int, shared: str) -> None:
    """`--fleet-replica RANK DIR`: one replica process of `[fleet]`. It
    sets its fleet identity, streams its trace into DIR/fleet, prepares
    the softmax scorer at optlevel 3 (one row plan, K4) into a
    ScoringService with validate "force" on the ladder, warms it, and only
    then serves generation 0 on an ephemeral port, registers and beats.
    Then it follows the router's markers in DIR: it loads generation 1
    (warmed before it serves), retires generation 0, narrows its admission
    gate for the overload run, and at the end writes its metrics snapshot
    (K4's launches against its dispatches, compiles and captures after
    each generation's warmup, the scorer's wall and its wait for the block
    compile's locks) and exits. The last replica SIGKILLs itself once it
    has answered FLEET_KILL_AFTER requests. A replica that cannot see the
    card fails: it never serves on the CPU."""
    import signal

    if not torch.cuda.is_available():
        fail("[fleet] a replica cannot see the card: it never serves on "
             "the CPU")
    from systemml_tpu_torch import fleet
    from systemml_tpu_torch.api.jmlc import Connection
    from systemml_tpu_torch.api.serving import ScoringService
    from systemml_tpu_torch.codegen import build, kernels
    from systemml_tpu_torch.obs import fleet as obs_fleet
    from systemml_tpu_torch.obs import trace as obs

    with open(os.path.join(shared, "fleet.json")) as f:
        spec = json.load(f)
    fleet_dir = os.path.join(shared, "fleet")
    victim = spec["replicas"] - 1
    deadline = time.monotonic() + spec["limit_s"]
    torch.backends.cuda.matmul.allow_tf32 = False
    # every process derives the run's id alike from the shared facts: the
    # directory that is the fleet's meeting point and the process count
    obs_fleet.set_identity(
        obs_fleet.derive_run_id(shared, spec["replicas"] + 1), rank, rank,
        0, spec["replicas"] + 1)
    rec = obs.FlightRecorder()
    obs.install(rec)
    writer = obs_fleet.attach_shard(rec, fleet_dir)
    src = JMLC_SCRIPTS["softmax"][0]
    services, warm, clocks = {}, {}, {}

    def build_generation(g):
        t0 = time.perf_counter()
        ps = Connection(config(3)).prepare_script(src, **_fleet_names())
        w, b = fleet_weights(g)
        svc = ScoringService(ps, constants={"W": w, "b": b},
                             ladder=SERVING_LADDER, validate="force")
        warmed = svc.warmup(K)
        torch.cuda.synchronize()
        st = ps.stats
        warm[g] = {"seconds": time.perf_counter() - t0, "warmed": warmed,
                   "compiles": st.compile_count,
                   "captures": st.block_graph_counts.get("capture", 0),
                   "requests": svc.registry.get("requests_total").value}
        clocks[g] = _WaitClock(ps)
        services[g] = svc

    answered = [0]
    lock = threading.Lock()
    parts = {"wall": 0.0, "lock_wait": 0.0, "requests": 0}

    def factory(g):
        svc, clock = services[g], clocks[g]

        def score(payload):
            t0 = time.perf_counter()
            clock.take()
            x = np.asarray(payload["x"], dtype=np.float32)
            y = svc.score(x)["yhat"].cpu().tolist()
            wait, _ = clock.take()
            with lock:
                parts["wall"] += time.perf_counter() - t0
                parts["lock_wait"] += wait
                parts["requests"] += 1
                answered[0] += 1
                n = answered[0]
            if rank == victim and n == spec["kill_after"]:
                with open(os.path.join(shared, "dying"), "w") as f:
                    f.write(str(time.time_ns()))
                os.kill(os.getpid(), signal.SIGKILL)
            return {"yhat": y}
        return score

    build_generation(0)
    builds_at_warmup = sorted(os.path.basename(p)
                              for p in build.build_reports)
    # what this replica built to warm up, for the router's check that no
    # source was built twice (the last replica leaves no snapshot)
    with open(os.path.join(shared, f"builds_{rank}.json"), "w") as f:
        json.dump(builds_at_warmup, f)
    reset_launches(kernels)
    replica = fleet.Replica(factory, fleet_dir=fleet_dir)
    replica.serve(0, port=0)
    replica.register(0)
    replica.start_heartbeat(FLEET_HEARTBEAT_S)

    def marker(name):
        return os.path.exists(os.path.join(shared, name))

    def ack(name):
        open(os.path.join(shared, f"{name}_{rank}"), "w").close()

    done = set()
    while not marker("phase_done"):
        if time.monotonic() > deadline or os.getppid() == 1:
            fail(f"[fleet] replica {rank}: the router is gone or the phase "
                 f"ran past its limit")
        if "g1" not in done and marker("rollout_go"):
            build_generation(1)
            replica.serve(1, port=0)
            replica.heartbeat()
            ack("g1_ready")
            done.add("g1")
        if "retire" not in done and marker("retire_g0"):
            replica.retire_generation(0)
            ack("retired")
            done.add("retire")
        if "overload" not in done and marker("overload_go"):
            replica.gate.inflight_max = spec["overload_inflight"]
            ack("overload_ready")
            done.add("overload")
        time.sleep(0.01)
    replica.close()
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    after = {}
    dispatches = 0
    for g, svc in services.items():
        st = svc._ps.stats
        served = svc.registry.get("requests_total").value
        # generation 0's warmup ran before the counters were set to 0;
        # generation 1's ran after, and its dispatches launch K4 too
        dispatches += served - (warm[g]["requests"] if g == 0 else 0)
        after[g] = {"compiles": st.compile_count - warm[g]["compiles"],
                    "captures": st.block_graph_counts.get("capture", 0)
                    - warm[g]["captures"],
                    "served": served - warm[g]["requests"]}
    rejects = dict(replica._m_admission_rejects.items())
    service = replica.registry.get("fleet_service_seconds")
    writer.close()
    obs.install(None)
    obs_fleet.write_metrics_snapshot(fleet_dir, services[0]._ps.stats, extra={
        "launches": launches, "dispatches": dispatches,
        "warmup": {str(g): w for g, w in warm.items()},
        "after_warmup": {str(g): a for g, a in after.items()},
        "builds_at_warmup": builds_at_warmup,
        "builds_at_end": sorted(os.path.basename(p)
                                for p in build.build_reports),
        "admission_rejects": rejects,
        "service_p50_ms": 1e3 * service.quantile(0.5),
        "score_wall_ms_mean": 1e3 * parts["wall"] / max(1, parts["requests"]),
        "lock_wait_share": parts["lock_wait"] / max(1e-12, parts["wall"]),
        "replica_registry": replica.registry.to_dict()})
    print(f"[fleet] replica {rank} done: launches {launches}, dispatches "
          f"{dispatches}", flush=True)


class _Request(dict):
    """A request payload (encoded as the dict it is) that carries a
    sequence number the transport can read and does not send."""

    seq = -1


class _AttemptLog:
    """Wraps a Router transport: the addresses each request was sent to,
    in order (a redispatch or a hedge adds one), by its sequence number."""

    def __init__(self, send):
        self._send = send
        self._lock = threading.Lock()
        self.sent: Dict[int, list] = {}

    def __call__(self, addr, request, remaining_s=None):
        with self._lock:
            self.sent.setdefault(request.seq, []).append(addr)
        return self._send(addr, request, remaining_s=remaining_s)


def _picking_router(fleet):
    """fleet.Router that logs each pick with the epoch the table had when
    the pick began (read before the targets: a pick that read the bumped
    epoch read the bumped targets too)."""
    class Picking(fleet.Router):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.picks = []

        def _pick(self, prog_gen, exclude=()):
            epoch = self.table.epoch
            rank, addr = super()._pick(prog_gen, exclude)
            if rank is not None:
                self.picks.append((epoch, rank))
            return rank, addr
    return Picking


def fleet_host_rows(dev) -> np.ndarray:
    """The host copy of X's first rows, as `[serving]` takes it, without
    the rest of make_data's targets."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=gen, device=dev)
    host = x[:SERVING_HOST_ROWS].cpu().numpy()
    del x
    torch.cuda.empty_cache()
    return host


def _fleet_k4(dev, kernels, smi) -> dict:
    """K4 at the scorer's plan and the largest rung the fleet's requests
    reach (64 rows) against its plain version, timed."""
    from systemml_tpu_torch.api.jmlc import Connection
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    ps = Connection(config(3)).prepare_script(JMLC_SCRIPTS["softmax"][0],
                                              **_fleet_names())
    hop = [h for h in iter_spoof_hops(ps._program)
           if h.params["template"] == "row"][0]
    leaf = list(hop.params["leaf_names"])
    m = FLEET_MAX_ROWS
    gen = torch.Generator(device=dev).manual_seed(23)
    z = torch.randn(m, SERVING_CLASSES, generator=gen, device=dev)
    bias = torch.randn(1, SERVING_CLASSES, generator=gen, device=dev)
    env = dict(zip(leaf, (z, bias, (z + bias).amax(dim=1, keepdim=True))))
    agg = hop.params["row_agg"]
    got = kernels.row_kernel(hop.params["plan"], leaf, agg, env)
    plain = kernels.row_plain(hop.params["plan"], leaf, agg,
                              {k: v.double() for k, v in env.items()})
    err = normwise(got, plain)
    rec = {"shape": [m, SERVING_CLASSES], "max_normwise": err,
           "max_abs_err": float((got.double() - plain).abs().max()),
           "ms": device_ms(lambda: kernels.row_kernel(
               hop.params["plan"], leaf, agg, env), cold=True),
           "plain_ms": device_ms(lambda: kernels.row_plain(
               hop.params["plan"], leaf, agg, env))}
    rec["bound_ms"], rec["bound_by"] = spoof_bound(
        hop.params["plan"], env, 4 * m, m * SERVING_CLASSES)
    print(f"[fleet] K4 spoof_row {agg} at the scorer's plan ({m}, "
          f"{SERVING_CLASSES}) fp32 on {smi}: device time {rec['ms']:.4f} ms "
          f"with the L2 cache evicted, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}); normwise "
          f"{err:.3e} against the plain version in fp64", flush=True)
    if not err <= SPOOF_BARS[torch.float32]:
        fail(f"[fleet] K4 at the scorer's plan: {err} from its plain "
             f"version")
    return rec


def _json_shares(samples, mean_wall_s, rate_per_s) -> dict:
    """Host ms of the JSON encode and decode of a request on each side,
    single-threaded over sampled requests of the run (each payload and
    answer as the run sent them), their share of the mean routed
    request's wall, and the router's JSON seconds per second of the run at
    its request rate (the router is one process: its threads share one
    interpreter lock)."""
    enc = dec = renc = rdec = 0.0
    for payload, answer in samples:
        t0 = time.perf_counter()
        body = json.dumps(payload).encode("utf-8")
        t1 = time.perf_counter()
        json.loads(body.decode("utf-8"))
        t2 = time.perf_counter()
        reply = json.dumps(answer).encode("utf-8")
        t3 = time.perf_counter()
        json.loads(reply.decode("utf-8"))
        t4 = time.perf_counter()
        enc, rdec, renc, dec = enc + t1 - t0, rdec + t2 - t1, \
            renc + t3 - t2, dec + t4 - t3
    n = max(1, len(samples))
    router_ms, replica_ms = 1e3 * (enc + dec) / n, 1e3 * (rdec + renc) / n
    return {"samples": len(samples),
            "router_encode_decode_ms": router_ms,
            "router_json_per_s": router_ms * rate_per_s / 1e3,
            "replica_decode_encode_ms": replica_ms,
            "mean_request_ms": 1e3 * mean_wall_s,
            "router_share": router_ms / (1e3 * mean_wall_s),
            "replica_share": replica_ms / (1e3 * mean_wall_s)}


def fleet_phase(host, dev, kernels, smi, serving=None) -> dict:
    """`[fleet]`: FLEET_REPLICAS replica processes (fresh interpreters,
    `chip_smoke.py --fleet-replica`, each with a CUDA context of its own)
    serve the softmax scorer of `[serving]` behind a Router over
    http_transport in this process. FLEET_CLIENTS threads send log-uniform
    1-FLEET_MAX_ROWS-row requests of `host`; the last replica SIGKILLs
    itself mid-stream; then a rolling update from generation 0 to 1 runs
    under the same load, and an overload run follows (each survivor
    admits FLEET_OVERLOAD_INFLIGHT requests, requests arrive open-loop at
    twice the first run's rate). Checks (each fails the run): no client
    request failed in the closed-loop run; every answer carries its rank
    and generation, is within FLEET_BAR of torch's softmax on the card
    with that generation's W and b and more than FLEET_GAP from the
    other's; the death was one route-epoch bump, and no pick of the dead
    replica read that epoch; each survivor's K4 launches equal its
    optlevel-3 dispatches, nothing compiled or captured after either
    generation's warmup, no plan source built by two processes; the
    merged shards give the rollout storyline g0 -> g1 and the epoch in
    the failover storyline; in the overload run every request was served
    within its deadline or shed with a named 429 reason, redispatches,
    shed retries and hedges stayed within the retry budget, and
    overload_summary counts the replicas' sheds; `python -m
    systemml_tpu_torch.obs.fleet_trace` exits 0 and prints both
    storylines. Every child is killed in a `finally`."""
    import signal
    from concurrent.futures import ThreadPoolExecutor as Pool

    from systemml_tpu_torch import fleet
    from systemml_tpu_torch.codegen import build
    from systemml_tpu_torch.fleet import admission
    from systemml_tpu_torch.obs import fleet as obs_fleet
    from systemml_tpu_torch.obs import trace as obs

    t_phase = time.perf_counter()
    builds_before = set(build.build_reports)
    limit = time.monotonic() + FLEET_LIMIT_S
    shared = tempfile.mkdtemp(prefix="smtpu_fleet_")
    fleet_dir = os.path.join(shared, "fleet")
    os.makedirs(fleet_dir)
    nrep, victim = FLEET_REPLICAS, FLEET_REPLICAS - 1
    survivors = list(range(nrep - 1))
    spec = {"replicas": nrep, "kill_after": FLEET_KILL_AFTER,
            "overload_inflight": FLEET_OVERLOAD_INFLIGHT,
            "limit_s": FLEET_LIMIT_S}
    with open(os.path.join(shared, "fleet.json"), "w") as f:
        json.dump(spec, f)

    def left() -> float:
        if time.monotonic() > limit:
            fail(f"[fleet] the phase ran past its limit of "
                 f"{FLEET_LIMIT_S:.0f} s; replica logs in {shared}")
        return limit - time.monotonic()

    def log_tail(r) -> str:
        with open(os.path.join(shared, f"replica_{r}.log")) as f:
            return f.read()[-3000:]

    def wait_for(cond, what):
        while not cond():
            for r, p in enumerate(procs):
                if p.poll() is not None and not (r == victim and os.path.exists(
                        os.path.join(shared, "dying"))):
                    fail(f"[fleet] replica {r} exited ({p.returncode}) "
                         f"waiting for {what}:\n{log_tail(r)}")
            left()
            time.sleep(0.01)

    def marker(name):
        open(os.path.join(shared, name), "w").close()

    def acked(name, ranks):
        return lambda: all(os.path.exists(
            os.path.join(shared, f"{name}_{r}")) for r in ranks)

    procs, logs = [], []
    rec = obs.FlightRecorder()
    prev = obs.install(rec)
    writer = None
    try:
        t0 = time.perf_counter()
        for r in range(nrep):
            logs.append(open(os.path.join(shared, f"replica_{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--fleet-replica", str(r), shared], cwd=ROOT,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        # the replicas start cold together: one builds K4's plan library
        # under the build lock, the others wait for it and load it
        wait_for(lambda: len(fleet.read_registry(
            fleet_dir, note_clocks=False)) == nrep, "the registry")
        start_s = time.perf_counter() - t0
        # K4 at the fleet's largest rung (this process builds nothing:
        # the library is there)
        k4 = _fleet_k4(dev, kernels, smi)
        k4["router_builds"] = sorted(os.path.basename(p) for p in set(
            build.build_reports) - builds_before)
        # this process is the router's lane, after the replicas'; one
        # host, one clock: a registry row's age is no clock probe
        run_id = obs_fleet.derive_run_id(shared, nrep + 1)
        obs_fleet.set_identity(run_id, nrep, nrep, 0, nrep + 1)
        writer = obs_fleet.attach_shard(rec, fleet_dir)
        reg = fleet.read_registry(fleet_dir, note_clocks=False)
        table = fleet.RoutingTable()
        table.install({(q, 0): info.url(0) for q, info in reg.items()})
        urls = {info.url(0): q for q, info in reg.items()}
        send = _AttemptLog(fleet.http_transport(timeout_s=30.0))
        router = _picking_router(fleet)(
            table, send, straggler_report=lambda: {"slowest_rank": 1},
            hedge_floor_s=0.010, hedge_min_samples=8)
        print(f"[fleet] {nrep} replica processes warmed and registered in "
              f"{start_s:.2f} s on {smi}", flush=True)

        lock = threading.Lock()
        stop = threading.Event()
        done, failures = [], []
        seq = [0]
        rng = np.random.default_rng(FLEET_SEED)
        seeds = rng.integers(0, 2**31, FLEET_CLIENTS)

        def client(c):
            crng = np.random.default_rng(int(seeds[c]))
            while not stop.is_set():
                n = int(np.clip(np.exp(crng.uniform(
                    0.0, math.log(FLEET_MAX_ROWS))), 1, FLEET_MAX_ROWS))
                r0 = int(crng.integers(0, len(host) - n + 1))
                payload = _Request(x=host[r0:r0 + n].tolist())
                with lock:
                    seq[0] += 1
                    payload.seq = seq[0]
                t1 = time.perf_counter()
                try:
                    resp = router.submit(payload, timeout_s=30.0)
                except Exception as e:  # the run fails on it below
                    with lock:
                        failures.append(repr(e))
                    continue
                t2 = time.perf_counter()
                with lock:
                    done.append((t1, t2, time.time_ns(), r0, n,
                                 resp.get("rank"), resp.get("prog_gen"),
                                 resp.get("outputs", {}).get("yhat"),
                                 payload.seq))

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(FLEET_CLIENTS)]
        t_first = time.perf_counter()
        for t in threads:
            t.start()
        wait_for(lambda: victim not in table.live_ranks()
                 and len(done) >= FLEET_FIRST_REQUESTS or failures,
                 "the first run")
        first_s = time.perf_counter() - t_first
        n_first = len(done)
        if failures:
            fail(f"[fleet] {len(failures)} client requests failed in the "
                 f"first run: {failures[:3]}")
        if procs[victim].wait(timeout=left()) != -signal.SIGKILL:
            fail(f"[fleet] replica {victim} exited "
                 f"{procs[victim].returncode}, not by its SIGKILL:\n"
                 f"{log_tail(victim)}")
        with open(os.path.join(shared, "dying")) as f:
            kill_ns = int(f.read())
        bump_epoch = table.epoch

        # the rolling update g0 -> g1 under the same load
        marker("rollout_go")
        wait_for(acked("g1_ready", survivors), "generation 1's warmup")
        for q, info in fleet.read_registry(fleet_dir,
                                           note_clocks=False).items():
            if q in survivors and info.url(1):
                table.add(q, 1, info.url(1))

        def retire(from_gen):
            marker("retire_g0")
            wait_for(acked("retired", survivors), "generation 0's retirement")

        t_roll = time.perf_counter()
        fleet.RollingUpdate(router, 0, 1).run(retire=retire,
                                              drain_timeout_s=60.0)
        rollout_s = time.perf_counter() - t_roll
        time.sleep(FLEET_AFTER_ROLLOUT_S)
        stop.set()
        for t in threads:
            t.join(timeout=left())
        closed_s = time.perf_counter() - t_first
        if failures:
            fail(f"[fleet] {len(failures)} client requests failed in the "
                 f"rollout: {failures[:3]}")

        # the overload run: open-loop arrivals at twice the first rate
        marker("overload_go")
        wait_for(acked("overload_ready", survivors), "the narrowed gates")
        rate = 2.0 * n_first / first_s
        before = {k: router.registry.get(k).value for k in (
            "fleet_requests_total", "fleet_redispatch_total",
            "fleet_shed_retries_total", "fleet_hedges_total",
            "fleet_retry_budget_exhausted_total")}
        outcomes, over_fail, queued = [], [], []

        def one(i, t_arrive):
            crng = np.random.default_rng(10_000 + i)
            n = int(np.clip(np.exp(crng.uniform(
                0.0, math.log(FLEET_MAX_ROWS))), 1, FLEET_MAX_ROWS))
            r0 = int(crng.integers(0, len(host) - n + 1))
            t1 = time.perf_counter()
            payload = _Request(x=host[r0:r0 + n].tolist())
            try:
                resp = router.submit(payload,
                                     timeout_s=FLEET_OVERLOAD_DEADLINE_S)
                wall = time.perf_counter() - t1
                with lock:
                    queued.append(t1 - t_arrive)
                    outcomes.append(("served", wall, None))
                    done.append((t1, t1 + wall, time.time_ns(), r0, n,
                                 resp.get("rank"), resp.get("prog_gen"),
                                 resp.get("outputs", {}).get("yhat"), -1))
            except admission.AdmissionRejectedError as e:
                with lock:
                    queued.append(t1 - t_arrive)
                    outcomes.append(("shed", time.perf_counter() - t1,
                                     e.reason))
            except Exception as e:  # the run fails on it below
                with lock:
                    over_fail.append(repr(e))

        issued = 0
        t_over = time.perf_counter()
        with Pool(max_workers=FLEET_OVERLOAD_SENDERS) as pool:
            while True:
                now = time.perf_counter() - t_over
                if now >= FLEET_OVERLOAD_S:
                    break
                while issued < rate * now:
                    pool.submit(one, issued, time.perf_counter())
                    issued += 1
                time.sleep(0.001)
            issue_s = time.perf_counter() - t_over
        over_s = time.perf_counter() - t_over
        marker("phase_done")
        for q in survivors:
            if procs[q].wait(timeout=left()) != 0:
                fail(f"[fleet] replica {q} exited {procs[q].returncode}:\n"
                     f"{log_tail(q)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=60)
        for log in logs:
            log.close()
        if writer is not None:
            writer.close()
        obs.install(prev)
        obs_fleet.clear_identity()
    end_epoch_events = [e.args for e in rec.events()
                        if e.name == "fleet_route_epoch"]

    # every answer against torch's softmax on the card, per generation
    refs = {g: tuple(torch.from_numpy(a).to(dev).double()
                     for a in fleet_weights(g)) for g in (0, 1)}
    worst, gap = 0.0, math.inf
    by_rank, by_gen = {}, {}
    for (_, _, _, r0, n, rank, g, y, _) in done:
        if g not in (0, 1) or rank not in range(nrep) or y is None:
            fail(f"[fleet] an answer without its rank and generation: "
                 f"rank {rank}, prog_gen {g}")
        xs = torch.from_numpy(host[r0:r0 + n]).to(dev).double()
        got = torch.tensor(y, dtype=torch.float64, device=dev)
        if tuple(got.shape) != (n, SERVING_CLASSES):
            fail(f"[fleet] an answer of shape {tuple(got.shape)} for {n} "
                 f"rows")
        ref = torch.softmax(xs @ refs[g][0] + refs[g][1], dim=1)
        other = torch.softmax(xs @ refs[1 - g][0] + refs[1 - g][1], dim=1)
        worst = max(worst, normwise(got, ref))
        gap = min(gap, normwise(got, other))
        by_rank[rank] = by_rank.get(rank, 0) + 1
        by_gen[g] = by_gen.get(g, 0) + 1

    # the first run's latencies, and the kill's first redispatched answer
    first = done[:n_first]
    lat = [t2 - t1 for (t1, t2, *_rest) in first]
    victim_urls = {u for u, q in urls.items() if q == victim}
    redone = []
    for (_, _, t_ns, _, _, _, _, _, s) in done:
        sent = send.sent.get(s, [])
        if len(sent) > 1 and victim_urls & set(sent) and t_ns > kill_ns:
            redone.append(t_ns)
    kill_to_redispatch_ms = ((min(redone) - kill_ns) / 1e6 if redone
                             else None)
    rank_picks_after = [r for e, r in router.picks
                        if e >= bump_epoch and r == victim]
    samples = [({"x": host[r0:r0 + n].tolist()},
                {"rank": rank, "prog_gen": g, "outputs": {"yhat": y}})
               for (_, _, _, r0, n, rank, g, y, _) in
               first[::max(1, len(first) // FLEET_JSON_SAMPLES)]]
    shares = _json_shares(samples, sum(lat) / len(lat), n_first / first_s)

    # the survivors' snapshots, rolled up
    snaps = obs_fleet.load_metrics_snapshots(fleet_dir,
                                             run_id=run_id)
    roll = obs_fleet.rollup_metrics(snaps)
    extra = {s["identity"]["orig_rank"]: s.get("extra", {}) for s in snaps}
    launches = {k: sum(e["launches"][k] for e in extra.values())
                for k in read_launches(kernels)}
    merged = obs_fleet.merge_dir(fleet_dir)
    story = obs_fleet.failover_storyline(merged)
    rollout = obs_fleet.rollout_storyline(merged)
    overload = obs_fleet.overload_summary(merged)
    cli = subprocess.run([sys.executable, "-m",
                          "systemml_tpu_torch.obs.fleet_trace", fleet_dir],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    reg_m = router.registry
    counts = {k: reg_m.get(k).value for k in (
        "fleet_requests_total", "fleet_failed_requests_total",
        "fleet_redispatch_total", "fleet_hedges_total",
        "fleet_hedge_wins_total", "fleet_hedges_cancelled_total",
        "fleet_shed_retries_total", "fleet_retry_budget_exhausted_total")}
    served_over = [o for o in outcomes if o[0] == "served"]
    shed_over = [o for o in outcomes if o[0] == "shed"]
    replica_rejects = sum(sum(e["admission_rejects"].values())
                          for e in extra.values())
    rec_out = {
        "replicas": nrep, "start_s": start_s, "k4_fleet": k4,
        "first": {"requests": n_first, "seconds": first_s,
                  "requests_per_s": n_first / first_s,
                  "p50_ms": 1e3 * _pct(lat, 0.5),
                  "p99_ms": 1e3 * _pct(lat, 0.99),
                  "rows": sum(n for (_, _, _, _, n, *_r) in first)},
        "closed_loop": {"requests": len(done) - len(served_over),
                        "seconds": closed_s},
        "kill_to_first_redispatched_answer_ms": kill_to_redispatch_ms,
        "rollout_s": rollout_s, "by_rank": by_rank, "by_gen": by_gen,
        "router": counts, "epoch_events": end_epoch_events,
        "worst_normwise": worst, "least_gap": gap, "json": shares,
        "overload": {"target_rate": rate, "issued": issued,
                     "offered_per_s": issued / issue_s,
                     "seconds": over_s,
                     "served": len(served_over), "shed": len(shed_over),
                     "shed_reasons": {r: sum(1 for o in shed_over
                                             if o[2] == r)
                                      for r in {o[2] for o in shed_over}},
                     "served_p99_ms": 1e3 * _pct([o[1] for o in served_over],
                                                 0.99)
                     if served_over else None,
                     "senders": FLEET_OVERLOAD_SENDERS,
                     "queued_p99_ms": 1e3 * _pct(queued, 0.99)
                     if queued else None,
                     "replica_rejects": replica_rejects,
                     "summary": overload,
                     "router_delta": {k: reg_m.get(k).value - v
                                      for k, v in before.items()}},
        "launches": launches,
        "survivors": {q: {k: extra[q][k] for k in (
            "launches", "dispatches", "after_warmup", "warmup",
            "builds_at_warmup", "builds_at_end", "admission_rejects",
            "service_p50_ms", "score_wall_ms_mean", "lock_wait_share")}
            for q in sorted(extra)},
        "rollup_ranks": sorted(roll["ranks"]),
        "storyline": [s["name"] for s in story],
        "rollout": [s["name"] for s in rollout],
        "seconds": time.perf_counter() - t_phase}
    f1, ov = rec_out["first"], rec_out["overload"]
    print(f"[fleet] first run through the router on {smi}: {n_first} "
          f"requests ({f1['rows']} rows) from {FLEET_CLIENTS} clients in "
          f"{first_s:.3f} s: per request p50 {f1['p50_ms']:.3f} ms, p99 "
          f"{f1['p99_ms']:.3f} ms (host wall, answer on the host), "
          f"{f1['requests_per_s']:.1f} requests/s; beside it [serving]'s "
          f"one process under {SERVING_CLIENTS} direct clients: "
          + (f"{serving['direct']['requests_per_s']:.1f} requests/s, p50 "
             f"{serving['direct']['p50_ms']:.3f} ms"
             if serving else "not run in this call"), flush=True)
    print(f"[fleet] answers by replica {by_rank}, by generation {by_gen}; "
          f"router {counts}; kill to the first redispatched answer "
          f"{kill_to_redispatch_ms} ms; rollout g0 -> g1 {rollout_s:.3f} s; "
          f"worst normwise against its generation's softmax {worst:.3e}, "
          f"least against the other's {gap:.3e}", flush=True)
    print(f"[fleet] JSON per request, {shares['samples']} sampled requests "
          f"of the first run, one thread on the host: router encode and "
          f"decode {shares['router_encode_decode_ms']:.4f} ms "
          f"({shares['router_share']:.3f} of the mean request's "
          f"{shares['mean_request_ms']:.3f} ms; at the first run's rate "
          f"{shares['router_json_per_s']:.3f} s of JSON a second in the "
          f"router's one process), replica decode and encode "
          f"{shares['replica_decode_encode_ms']:.4f} ms "
          f"({shares['replica_share']:.3f})", flush=True)
    for q, e in rec_out["survivors"].items():
        print(f"[fleet] replica {q}: K4 launches {e['launches']['spoof_row']}"
              f", dispatches {e['dispatches']}; after warmup {e['after_warmup']}"
              f"; builds {e['builds_at_end']}; scorer wall "
              f"{e['score_wall_ms_mean']:.3f} ms a request, its wait for "
              f"the block compile's locks {e['lock_wait_share']:.3f} of it; "
              f"429s {e['admission_rejects']}", flush=True)
    print(f"[fleet] overload on {smi}: {issued} requests offered at "
          f"{ov['offered_per_s']:.1f}/s (target {rate:.1f}/s) over "
          f"{issue_s:.2f} s into {FLEET_OVERLOAD_SENDERS} senders (p99 "
          f"{ov['queued_p99_ms']} ms waiting for one), done by "
          f"{over_s:.2f} s: {len(served_over)} served (p99 "
          f"{ov['served_p99_ms']} ms), {len(shed_over)} shed "
          f"{ov['shed_reasons']}; replicas' 429s {replica_rejects}; "
          f"overload_summary {overload['by_reason']}; router "
          f"{ov['router_delta']}", flush=True)
    print(f"[fleet] storylines: failover {rec_out['storyline']}, rollout "
          f"{rec_out['rollout']}; phase {rec_out['seconds']:.1f} s on {smi}",
          flush=True)

    # the checks
    if set(by_rank) != set(range(nrep)):
        fail(f"[fleet] answers by replica {by_rank}: not all {nrep} served")
    if not (worst <= FLEET_BAR and gap > FLEET_GAP):
        fail(f"[fleet] an answer {worst:.3e} from its generation's softmax "
             f"(bar {FLEET_BAR}) or {gap:.3e} from the other's (at least "
             f"{FLEET_GAP})")
    if set(by_gen) != {0, 1}:
        fail(f"[fleet] answers by generation {by_gen}")
    if end_epoch_events != [{"epoch": bump_epoch, "dead": [victim],
                             "reason": "transport"}] or bump_epoch != 1:
        fail(f"[fleet] the kill gave route epochs {end_epoch_events}, not "
             f"one bump for replica {victim}")
    if rank_picks_after:
        fail(f"[fleet] {len(rank_picks_after)} picks of the dead replica "
             f"read epoch {bump_epoch} or later")
    if counts["fleet_failed_requests_total"] or counts[
            "fleet_redispatch_total"] < 1:
        fail(f"[fleet] router {counts}")
    if sorted(extra) != survivors or rec_out["rollup_ranks"] != survivors:
        fail(f"[fleet] snapshots of {sorted(extra)}, rollup "
             f"{rec_out['rollup_ranks']}, not the survivors {survivors}")
    built = k4["router_builds"]
    for q in range(nrep):
        with open(os.path.join(shared, f"builds_{q}.json")) as f:
            built = built + (extra[q]["builds_at_end"] if q in extra
                             else json.load(f))
    rec_out["builds"] = built
    print(f"[fleet] plan sources built during the phase, by any of its "
          f"processes: {built}", flush=True)
    if len(built) != len(set(built)):
        fail(f"[fleet] a plan source built by two processes: {built}")
    for q, e in extra.items():
        if e["launches"]["spoof_row"] != e["dispatches"] or any(
                v for k, v in e["launches"].items() if k != "spoof_row"):
            fail(f"[fleet] replica {q}: launches {e['launches']} against "
                 f"{e['dispatches']} optlevel-3 dispatches")
        for g, a in e["after_warmup"].items():
            if a["compiles"] or a["captures"]:
                fail(f"[fleet] replica {q} generation {g}: {a} after "
                     f"warmup (no new rung: requests stay within 64 rows)")
    if "fleet_route_epoch" not in rec_out["storyline"]:
        fail(f"[fleet] failover storyline {rec_out['storyline']}")
    names = rec_out["rollout"]
    want = ["rollout_load"] * len(survivors) + ["rollout_start"] + \
        ["rollout_shift"] * 4 + ["rollout_drain"] + \
        ["rollout_retire"] * len(survivors) + ["rollout_done"]
    if names != want:
        fail(f"[fleet] rollout storyline {names}, not {want}")
    if over_fail:
        fail(f"[fleet] overload run: {len(over_fail)} requests neither "
             f"served nor shed with a named reason: {over_fail[:3]}")
    late = [o[1] for o in served_over
            if o[1] > FLEET_OVERLOAD_DEADLINE_S + FLEET_DEADLINE_SLACK_S]
    if late:
        fail(f"[fleet] overload run: {len(late)} requests served past their "
             f"deadline: {sorted(late)[-3:]} s")
    if not shed_over or any(o[2] not in admission.ADMISSION_REASONS
                            for o in shed_over):
        fail(f"[fleet] overload run: sheds {ov['shed_reasons']}")
    spends = (counts["fleet_redispatch_total"]
              + counts["fleet_shed_retries_total"]
              + counts["fleet_hedges_total"])
    bound = (router.budget.cap + router.budget.ratio
             * counts["fleet_requests_total"]
             + counts["fleet_retry_budget_exhausted_total"])
    if spends > bound + 1e-9:
        fail(f"[fleet] {spends} redispatches, shed retries and hedges "
             f"beyond the retry budget's {bound}")
    summed = sum(n for k, n in overload["by_reason"].items()
                 if k.startswith("fleet_admission_reject["))
    if summed != replica_rejects or not summed:
        fail(f"[fleet] overload_summary counts {summed} sheds, the replicas "
             f"{replica_rejects}")
    if cli.returncode != 0 or "Failover storyline" not in cli.stdout \
            or "Rollout storyline" not in cli.stdout:
        fail(f"[fleet] fleet_trace: {cli.returncode} {cli.stderr[-2000:]}")
    shutil.rmtree(shared, ignore_errors=True)
    return rec_out


def fleet_only() -> None:
    """The fleet phase alone (`[fleet]`): what `--fleet` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.codegen import kernels

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    res = fleet_phase(fleet_host_rows(dev), dev, kernels, smi)
    res["all_seconds"] = time.perf_counter() - t0
    print(json.dumps({"fleet": res}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


# --------------------------------------------------------------------------
# --bench: the spoof kernels and wrappers of this tree, for parent/change
# pairs in one chip call
# --------------------------------------------------------------------------

def _bench_hops(script_text=None, path=None, inputs=(), args=None):
    """The spoof hops of a script compiled at optlevel 3 with a CPU config
    (no build: each wrapper builds its plan at its first call)."""
    from systemml_tpu_torch.api.mlcontext import dml, dmlFromFile
    from systemml_tpu_torch.runtime.program import (compile_program,
                                                    iter_spoof_hops)
    from systemml_tpu_torch.utils.config import (DMLConfig, get_config,
                                                 set_config)

    s = dmlFromFile(path) if path else dml(script_text)
    for k in inputs:
        s.input(k, None)
    for k, v in (args or {}).items():
        s.arg(k, v)
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = 3
    old = get_config()
    set_config(cfg)
    try:
        prog = compile_program(s.parse(), clargs=s._args,
                               outputs=s._outputs, input_names=list(inputs))
    finally:
        set_config(old)
    return list(iter_spoof_hops(prog))


def host_us(fns: dict, reps: int = 250, rounds: int = 8):
    """Host microseconds per call of each fn of `fns` (name -> fn): the
    median over `rounds` rounds of `reps` calls, the fns taken in turns
    within a round, so that a slow spell of the shared host falls on all
    of them. Returns (medians, every round's reading) by name."""
    import statistics

    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[k].append(1e6 * (time.perf_counter() - t0) / reps)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}, times


def _bench_summary_ms(v, runs: int = 7) -> float:
    """The ratings summary at optlevel 3 through MLContext, end to end
    (parse, compile, execution, the three values read back): the median
    of `runs` after one run that builds its plan."""
    import statistics

    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    cfg = DMLConfig()
    cfg.optlevel = 3
    ml = MLContext(cfg)
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ml.execute(dml(SUMMARY).input("V", v).output("s", "lo", "hi"))
        [float(res.get(k)) for k in ("s", "lo", "hi")]
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def bench(label: str) -> None:
    """Times the spoof kernels K2, K3 and K5 at the paths' shapes, the host
    time of the spoof wrappers, K6 and LinearRegCG-cla, and prints the card
    and one JSON line:

    - k3_summary_ms: the ratings summary's plan (sum, min, max) over a
      ratings matrix of the MovieLens 10M shape, CUDA events;
    - k2_map_ms: that plan written out elementwise over the same matrix;
    - k5_loss_ms: ALS-CG's loss plan (the outer template) on that
      matrix's 0/1 pattern at rank 10, CUDA events, and the ptxas report
      of its source;
    - summary_optlevel3_ms: the ratings summary through MLContext at
      optlevel 3, end to end (host clock, the median of 7);
    - k2_l2svm_device_ms: l2-svm's 10-leaf line-search plan summed over
      (2,000,000, 1), device time per call (torch.profiler); its 24 MB
      stay in the 50 MB L2 cache across calls, so k2_l2svm_cold_l2_ms
      evicts the cache before each call; k2_als_device_ms and
      k2_als_cold_l2_ms likewise for ALS-CG's CG-reduction plan (the cell
      plan with the most leaves) over (71,567, 10);
    - dispatch_us: host microseconds per wrapper call on tiny inputs (cell
      sum, multi-aggregate, row), where the launch and not the work
      counts; in a tree whose compiler fixes each spoof hop's Variant,
      also the cell sum called with it, as the paths call it (medians of
      host_us's rounds, each round in dispatch_us_rounds);
    - cla_cg_iter_ms: LinearRegCG-cla at optlevel 2, cla "auto", on the
      Census-shaped X, ms per CG iteration (run_cla_path's device window);
    - k6_chain_ms: K6 at that X's own compressed layout, k = 1, fp32,
      XtXv, CUDA events over back-to-back chain_kernel calls;
      k6_chain_device_ms the device time per call (torch.profiler) and
      k6_host_us the wrapper's host time per call.

    It uses only the wrappers' (plan, names, agg, env) signatures,
    compile_program, MLContext and compress/device.py's chain_layout,
    chain_table and chain_kernel, so a checkout of an earlier tree runs it
    too, this file copied in: two trees compare within one chip call."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.codegen import build, kernels
    from systemml_tpu_torch.codegen.cplan import CNode

    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"label": label, "card": smi}
    users, movies = ML10M_USERS, ML10M_MOVIES

    # K3, K2's elementwise arm and K5 over a ratings matrix
    (magg,) = [h for h in _bench_hops(SUMMARY, inputs=("V",))
               if h.params["template"] == "multiagg"]
    mplan, mnames = magg.params["plan"], list(magg.params["leaf_names"])
    aggs = list(magg.params["aggs"])
    v = torch.randint(1, 11, (users, movies), generator=gen, device=dev,
                      dtype=torch.int8).to(torch.float32).div_(2.0)
    v.mul_(torch.rand(users, movies, generator=gen, device=dev)
           < ML10M_RATINGS / (users * movies))
    env = {mnames[0]: v, mnames[1]: v, mnames[2]: v.sum(),
           mnames[3]: (v != 0).sum().to(torch.float32)}
    out["k3_summary_ms"] = time_ms(
        [lambda: kernels.multiagg_kernel(mplan, mnames, aggs, env)],
        reps=10)[0]
    out["k2_map_ms"] = time_ms(
        [lambda: kernels.cell_kernel(mplan, mnames, None, env)], reps=5)[0]
    out["summary_optlevel3_ms"] = _bench_summary_ms(v)
    del env
    torch.cuda.empty_cache()
    als_hops = _bench_hops(path=os.path.join(ALG, "ALS-CG.dml"),
                           inputs=("V",), args=ALS_ARGS)
    (loss,) = [h for h in als_hops if h.params["template"] == "outer"]
    x = (v != 0).to(torch.float32)
    del v
    lf = torch.rand(users, 10, generator=gen, device=dev)
    rf = torch.rand(movies, 10, generator=gen, device=dev)
    out["k5_loss_ms"] = time_ms([lambda: kernels.outer_kernel(
        loss.params["plan"], x, lf, rf, {})], reps=10)[0]
    print_build_reports(build, only="spoof_outer")
    del x, lf, rf
    torch.cuda.empty_cache()

    # K2: l2-svm's 10-leaf plan over (2e6, 1)
    cells = [h for h in _bench_hops(path=os.path.join(ALG, "l2-svm.dml"),
                                    inputs=("X", "Y"))
             if h.params["template"] == "cell"]
    svm = max(cells, key=lambda h: len(h.params["leaf_names"]))
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    by_var = {"Y": torch.sign(r(M, 1)), "Xw": r(M, 1), "Xd": r(M, 1),
              "step_sz": torch.tensor(0.05, device=dev)}
    snames = list(svm.params["leaf_names"])
    senv = {nm: by_var[h.name] for nm, h in zip(snames, svm.inputs)}
    splan = svm.params["plan"]
    fn = lambda: kernels.cell_kernel(splan, snames, "sum", senv)
    out["k2_l2svm_device_ms"] = device_ms(fn)
    out["k2_l2svm_cold_l2_ms"] = device_ms(fn, cold=True)

    # K2: ALS-CG's CG-reduction plan over (users, rank 10)
    als = max((h for h in als_hops if h.params["template"] == "cell"),
              key=lambda h: len(h.params["leaf_names"]))
    anames = list(als.params["leaf_names"])
    aenv = {}
    for nm, h in zip(anames, als.inputs):
        if h.op == "ua(sum,all)" or (h.op == "tread" and h.name == "rr"):
            aenv[nm] = r(users, 10).square().sum()
        elif h.op == "tread" and h.name == "reg":
            aenv[nm] = 0.01
        elif h.op == "tread" and h.name == "wrow":
            aenv[nm] = torch.ones(users, 1, device=dev)
        else:
            aenv[nm] = r(users, 10) / 10
    aplan = als.params["plan"]
    fn = lambda: kernels.cell_kernel(aplan, anames, "sum", aenv)
    out["k2_als_device_ms"] = device_ms(fn)
    out["k2_als_cold_l2_ms"] = device_ms(fn, cold=True)
    out["plans"] = {"k3": mplan.pretty(), "k5": loss.params["plan"].pretty(),
                    "k2_l2svm": splan.pretty(), "k2_als": aplan.pretty()}

    # the host time of one wrapper call; one slice per variable: a
    # variable named twice is one object, as on the paths
    small = {id(t): (t[:1024] if t.ndim == 2 else t) for t in senv.values()}
    tiny_svm = {nm: small[id(t)] for nm, t in senv.items()}
    tv = torch.rand(64, 64, device=dev)
    tiny_magg = {mnames[0]: tv, mnames[1]: tv, mnames[2]: tv.sum(),
                 mnames[3]: (tv != 0).sum().to(torch.float32)}
    row = CNode("u(exp)", [CNode("b(-)", [CNode("in", name="i0"),
                                          CNode("in", name="i1")])])
    tiny_row = {"i0": torch.randn(1024, 5, device=dev),
                "i1": torch.randn(1024, 1, device=dev)}
    fns = {"cell_sum": lambda: kernels.cell_kernel(
               splan, snames, "sum", tiny_svm),
           "multiagg": lambda: kernels.multiagg_kernel(
               mplan, mnames, aggs, tiny_magg),
           "row": lambda: kernels.row_kernel(row, ["i0", "i1"], "sum",
                                             tiny_row)}
    if "variant" in svm.params:   # a tree whose compiler fixes Variants
        fns["cell_sum_hop_variant"] = lambda: kernels.cell_kernel(
            splan, snames, "sum", tiny_svm, svm.params["variant"])
    out["dispatch_us"], out["dispatch_us_rounds"] = host_us(fns)
    del senv, aenv, tiny_svm, tiny_magg, tiny_row
    torch.cuda.empty_cache()

    # K6 and LinearRegCG-cla on the Census-shaped X (compressed at the
    # loop's entry, as the path does)
    from systemml_tpu_torch.compress import device as cla_dev

    data = make_census(dev)
    run = run_cla_path("LinearRegCG", "auto", data, dev, kernels)
    out["cla_cg_iter_ms"] = run["windows"]["iteration_ms"]
    out["cla_cg_iterations"] = run["iterations"]
    lay = cla_dev.chain_layout(run["compressed"][0])
    sv = cla_dev.chain_table(
        lay, torch.randn(CENSUS_M, 1, generator=gen, device=dev))
    fn = lambda: cla_dev.chain_kernel(lay.codes, sv)
    out["k6_chain_ms"] = time_ms([fn], reps=50)[0]
    out["k6_chain_device_ms"] = device_ms(fn)
    out["k6_host_us"] = host_us({"k6": fn}, reps=100, rounds=4)[0]["k6"]
    print(smi)
    print(json.dumps(out), flush=True)


# K6_PROBE of csrc/cla_chain.cu: the kernel, and three builds whose
# results are wrong
K6_PROBES = {"full": 0, "no_atomics": 1, "plain_stores": 2, "copies_only": 3}


def phases() -> None:
    """Where K6's time goes, at the Census shape (68 groups of 8 codes over
    2,458,285 rows, uniform codes, k = 1, fp32, XtXv): csrc/cla_chain.cu
    built with each K6_PROBE (full: the kernel; no_atomics: phase B's
    atomics left out, their addresses and values still computed;
    plain_stores: plain shared-memory stores in their place; copies_only:
    each tile's codes copied into shared memory and nothing else), by nvcc
    in parallel, each launched through its own library on the same inputs
    as compress/device.chain_kernel launches K6. Prints the card, ptxas's
    registers and spills of each k = 1 kernel, full's normwise error
    against chain_plain, and one JSON line per probe: ms per call by CUDA
    events over back-to-back launches (the probes in turns) and device ms
    per call (torch.profiler); beside them the wrapper chain_kernel. Then
    the slab path at [k6-groups]' shape (K6_GROUPS groups): the kernel
    against its copies alone, device ms by kernel."""
    import ctypes

    from systemml_tpu_torch.codegen import build
    from systemml_tpu_torch.compress import device as cla_dev

    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.CSRC, "cla_chain.cu")
    procs = {}
    for name, probe in K6_PROBES.items():
        lib = os.path.join(build.BUILD_DIR, f"libcla_chain_probe{probe}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, f"-DK6_PROBE={probe}", "-I",
             build.CSRC, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    ref_lib = cla_dev._chain_library()
    libs = {}
    for name, (lib, p) in procs.items():
        report, _ = p.communicate(timeout=build.NVCC_TIMEOUT_S)
        if p.returncode:
            fail(f"nvcc for K6_PROBE={K6_PROBES[name]}:\n{report[-3000:]}")
        lines = report.splitlines()
        at = [i for i, ln in enumerate(lines)
              if "cla_chain_f32ILi1E" in ln and "Compiling" in ln]
        regs = [ln.split(":", 1)[-1].strip() for ln in
                lines[at[0] + 1:at[0] + 5] if "registers" in ln
                or "spill" in ln] if at else []
        print(f"[phases] {name} ptxas k=1: {'; '.join(regs)}", flush=True)
        h = ctypes.CDLL(lib)
        h.smtorch_cla_chain.argtypes = ref_lib.smtorch_cla_chain.argtypes
        h.smtorch_cla_chain.restype = ref_lib.smtorch_cla_chain.restype
        libs[name] = h

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    codes = cla_dev.chain_codes(torch.randint(
        0, 8, (CENSUS_M, CENSUS_N), generator=gen, device=dev,
        dtype=torch.uint8))
    sv = torch.randn(8, CENSUS_M, 1, generator=gen, device=dev)
    tile = cla_dev.chain_kernel_plan(8, CENSUS_M, 1, torch.float32)[0]
    grid = min(-(-CENSUS_N // tile), torch.cuda.get_device_properties(
        dev).multi_processor_count)
    partial = torch.empty((grid, 8, CENSUS_M, 1), dtype=torch.float64,
                          device=dev)
    outs = {name: torch.empty((8, CENSUS_M, 1), dtype=torch.float64,
                              device=dev) for name in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(name):
        h, out = libs[name], outs[name]

        def fn():
            err = h.smtorch_cla_chain(
                codes.data_ptr(), codes.stride(0), sv.data_ptr(), None,
                partial.data_ptr(), out.data_ptr(), None,
                CENSUS_N, CENSUS_M, 8, 1, 0, 1, 0, grid, stream)
            if err:
                fail(f"K6 probe {name}: CUDA error {err}")
        return fn

    fns = {name: launcher(name) for name in libs}
    fns["wrapper"] = lambda: cla_dev.chain_kernel(codes, sv)
    fns["full"]()
    ref = cla_dev.chain_plain(codes, sv.double())
    err = normwise(outs["full"], ref)
    print(f"[phases] full: normwise {err:.3e} against chain_plain "
          f"(bar {CHAIN_BARS[torch.float32]:g})", flush=True)
    if not err <= CHAIN_BARS[torch.float32]:
        fail(f"K6 probe full: normwise {err}")
    names = list(fns)
    events = time_ms([fns[k] for k in names], reps=50)
    result = {k: {"ms": events[i], "device_ms": device_ms(fns[k])}
              for i, k in enumerate(names)}
    print(smi)
    print(json.dumps(result), flush=True)
    del codes, partial, outs
    # the slab path at [k6-groups]' shape: K6_GROUPS groups, the kernel
    # against its copies alone, by kernel
    g = K6_GROUPS
    codes = cla_dev.chain_codes(torch.randint(
        0, 8, (g, CENSUS_N), generator=gen, device=dev, dtype=torch.uint8))
    sv = torch.randn(8, g, 1, generator=gen, device=dev)
    _, _, slabs = cla_dev.chain_kernel_plan(8, g, 1, torch.float32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = cla_dev.CHAIN_SLAB_BLOCKS_PER_SM * sms // slabs
    partial = torch.empty((grid, 8, g, 1), dtype=torch.float64, device=dev)
    z = torch.empty((CENSUS_N, 1), device=dev)
    out = torch.empty((8, g, 1), dtype=torch.float64, device=dev)

    def slab_launcher(name):
        h = libs[name]

        def fn():
            err = h.smtorch_cla_chain(
                codes.data_ptr(), codes.stride(0), sv.data_ptr(), None,
                partial.data_ptr(), out.data_ptr(), z.data_ptr(), CENSUS_N,
                g, 8, 1, 0, 1, 0, grid, stream)
            if err:
                fail(f"K6 slab probe {name}: CUDA error {err}")
        return fn

    split = {name: kernel_split(slab_launcher(name))
             for name in ("full", "copies_only")}
    print(f"[phases] slab path, {g} groups x {CENSUS_N} rows, k = 1, fp32 "
          f"({slabs} group slabs), device ms by kernel (profiler): {split}",
          flush=True)


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# the DNN slice: the normal draw, Caffe2DML ResNet-18, mnist_lenet's train()
# --------------------------------------------------------------------------

# Caffe2DML ResNet-18 (models/zoo.resnet18, BASELINE.md's north star) at
# its published widths: 3x224x224, 1,000 classes; 1,024 synthetic images,
# batch 64, one epoch: 16 steps of one flat loop
RESNET_N, RESNET_BS, RESNET_K = 1024, 64, 1000
# mnist_lenet.dml's train() at its widths (1x28x28, F1 32, F2 64, N3 512,
# 5x5, batch 64, dropout 0.5, sgd_nesterov): 6,400 synthetic rows (100
# iterations, one epoch), 640 for validation
LENET_N, LENET_VAL = 6400, 640
LENET_SRC = """
source("nn/examples/mnist_lenet.dml") as mnist_lenet
[W1, b1, W2, b2, W3, b3, W4, b4] = mnist_lenet::train(X, Y, X_val, Y_val,
                                                      1, 28, 28, 1)
probs = mnist_lenet::predict(X_val, 1, 28, 28, W1, b1, W2, b2, W3, b3, W4,
                             b4)
[loss, accuracy] = mnist_lenet::eval(probs, Y_val)
"""
# the loss of the same network at its initial weights: train()'s first
# draws, in its order, from the same global seed
LENET_INIT_SRC = """
source("nn/examples/mnist_lenet.dml") as mnist_lenet
source("nn/layers/affine.dml") as affine
source("nn/layers/conv2d_builtin.dml") as conv2d
[W1, b1] = conv2d::init(32, 1, 5, 5)
[W2, b2] = conv2d::init(64, 32, 5, 5)
[W3, b3] = affine::init(64 * 7 * 7, 512)
[W4, b4] = affine::init(512, ncol(Y_val))
W4 = W4 / sqrt(2)
probs = mnist_lenet::predict(X_val, 1, 28, 28, W1, b1, W2, b2, W3, b3, W4,
                             b4)
[loss, accuracy] = mnist_lenet::eval(probs, Y_val)
"""
LENET_PREDICT = """
source("nn/examples/mnist_lenet.dml") as mnist_lenet
probs = mnist_lenet::predict(X, 1, 28, 28, W1, b1, W2, b2, W3, b3, W4, b4)
"""


def check_normal(dev) -> dict:
    """rand(pdf="normal") on the card against the CPU's, bit for bit, in
    fp32 and fp64 (ops/datagen.normal: the JAX package's erf_inv in
    torch's basic ops), from a host seed and from a 0-d device seed (a
    loop region's)."""
    from systemml_tpu_torch.ops import datagen

    out = {}
    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.float64, torch.int64)):
        for rows, cols, seed in ((2000, 1000, 7), (64, 3 * 7 * 7, 42)):
            b = datagen.rand(rows, cols, pdf="normal", seed=seed,
                             dtype=dtype, device="cpu")
            for dev_seed in (False, True):
                sd = (torch.tensor(seed, device=dev) if dev_seed else seed)
                a = datagen.rand(rows, cols, pdf="normal", seed=sd,
                                 dtype=dtype, device=dev)
                same = bool(torch.equal(a.cpu().view(bits), b.view(bits)))
                key = (f"{rows}x{cols} seed {seed}"
                       f"{' (device seed)' if dev_seed else ''} "
                       f"{str(dtype)[6:]}")
                out[key] = same
                print(f"[normal] rand ({rows}, {cols}) pdf normal {key}: "
                      f"card equals CPU bit for bit {same}", flush=True)
                if not same:
                    fail(f"normal draw {key}: the card's differs from the "
                         f"CPU's")
    return out


POISSON_LAMBDAS = (0.5, 3.0, 9.99, 10.0, 50.0, 1000.0)


def check_poisson(dev) -> dict:
    """`[poisson]`: seeded rand(pdf="poisson") on the card against the
    CPU's, bit for bit, at every lambda of POISSON_LAMBDAS (Knuth's rounds
    below 10, the transformed rejection from 10 on), in fp32 and fp64.
    The draw is fp32 whatever the output dtype, and its values integers:
    one CPU draw per lambda (fp64) is held against the card's fp64 draw
    and, cast to fp32, against its fp32 draw."""
    from systemml_tpu_torch.ops import datagen

    out = {}
    rows, cols, seed = 256, 128, 11
    for lam in POISSON_LAMBDAS:
        t0 = time.perf_counter()
        b = datagen.rand(rows, cols, pdf="poisson", seed=seed, lambda_=lam,
                         dtype=torch.float64, device="cpu")
        cpu_s = time.perf_counter() - t0
        for dtype, bits in ((torch.float32, torch.int32),
                            (torch.float64, torch.int64)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = datagen.rand(rows, cols, pdf="poisson", seed=seed,
                             lambda_=lam, dtype=dtype, device=dev)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            same = bool(torch.equal(a.cpu().view(bits),
                                    b.to(dtype).view(bits)))
            key = f"lambda {lam:g} {str(dtype)[6:]}"
            out[key] = {"bit_identical": same, "card_s": card_s,
                        "cpu_s": cpu_s, "mean": float(a.double().mean())}
            print(f"[poisson] rand ({rows}, {cols}) pdf poisson seed {seed} "
                  f"{key}: card equals CPU bit for bit {same}; mean "
                  f"{float(a.double().mean()):.4f}; card {card_s:.3f} s, "
                  f"CPU {cpu_s:.3f} s", flush=True)
            if not same:
                fail(f"poisson draw {key}: the card's differs from the CPU's")
    return out


def _kernel_verdicts(label, calls, tune_mode, trials=2) -> dict:
    """The kernel backend's choice for each call of `calls` (family ->
    thunk) on a fresh memo: its source, its choice, each arm's median ms
    and measurements (tune_mode "online"), or the analytic costs
    ("off")."""
    from systemml_tpu_torch.codegen import backend, tune
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.utils.config import get_config

    cfg = get_config()
    saved = (cfg.codegen_tune_mode, cfg.codegen_tune_cache,
             cfg.codegen_tune_trials)
    cfg.codegen_tune_mode, cfg.codegen_tune_cache = tune_mode, ""
    cfg.codegen_tune_trials = trials
    out = {}
    try:
        for op, call in calls.items():
            backend.reset_process_state()
            with obs.session() as rec:
                call()
                torch.cuda.synchronize()
            sel = [e.args for e in rec.events() if e.name == "kernel_select"
                   and e.args["op"] == op]
            search = [e.args for e in rec.events()
                      if e.name == "kernel_search" and e.args["op"] == op]
            if len(sel) != 1:
                fail(f"[backend] {label} {op}: {len(sel)} selections")
            rounds = [e.args for e in rec.events()
                      if e.name == "kernel_select"]
            out[op] = {"choice": sel[0]["choice"], "source": sel[0]["source"],
                       "key": sel[0]["key"], "analytic_s": sel[0]["costs"],
                       "measurements": tune.measurement_count(),
                       "shortlist": search[0]["shortlist"] if search
                       else None, "selections": len(rounds)}
    finally:
        (cfg.codegen_tune_mode, cfg.codegen_tune_cache,
         cfg.codegen_tune_trials) = saved
        backend.reset_process_state()
    return out


def _measured_arms(op: str) -> dict:
    """Each measured arm's median ms and its number of measurements, from
    the tournament's meta (tune.measure), kept by the spy below."""
    meta = _TOURNAMENTS.get(op) or {}
    return {n: {"median_ms": 1e3 * t, "n": meta.get("n", {}).get(n)}
            for n, t in (meta.get("samples") or {}).items()}


# op -> the meta of its last tournament in this process (tune.measure)
_TOURNAMENTS: Dict[str, dict] = {}


class TournamentSpy:
    """For the duration of a with-block, keeps each tournament's meta
    (its arms' median seconds and counts) by family."""

    def __enter__(self):
        from systemml_tpu_torch.codegen import tune

        self._orig = tune.measure

        def measure(fam, order, ctx, args, kwargs):
            winner, meta = self._orig(fam, order, ctx, args, kwargs)
            if meta is not None:
                _TOURNAMENTS[fam.op] = dict(meta, winner=winner)
            return winner, meta

        tune.measure = measure
        return self

    def __exit__(self, *exc):
        from systemml_tpu_torch.codegen import tune

        tune.measure = self._orig


def backend_phase(data, cla, ratings, dev, kernels, smi, untuned) -> dict:
    """`[backend]`: the kernel backend's tuner on the main path. LinearRegCG
    at M x K fp32 (optlevel 2, its CG loop a region) with
    codegen_tune_mode "online" against a fresh temporary cache (read by no
    run before), then "cached" against it (measures and writes the
    verdict), then, after backend.reset_process_state() (a fresh
    process's memory), "cached" again: that run makes 0 measurements,
    picks the mmchain variant the online run picked, and gives beta equal
    bit for bit to the online run's, within 1e-3 of beta_true. The
    mmchain key's winner, each arm's median ms and its measurements; ms
    per CG iteration tuned (the cached run, and its second run on the
    same MLContext) against untuned (`untuned`: the main path's first and
    second runs); the analytic and measured verdicts of cla_right,
    cla_left and cla_mmchain at the Census shape (the LinearRegCG-cla
    block) and of the five quaternary families over ALS-CG-ml10m's V as
    CSR."""
    from systemml_tpu_torch.api.mlcontext import MLContext
    from systemml_tpu_torch.codegen import backend, tune
    from systemml_tpu_torch.compress import device as cla_dev
    from systemml_tpu_torch.ops import mult
    from systemml_tpu_torch.runtime.sparse import SparseMatrix
    from systemml_tpu_torch.utils.config import get_config, set_config

    cache = os.path.join(tempfile.mkdtemp(prefix="smtorch-tune-"),
                         "tune.json")
    beta_true = data["beta_true"].double()
    runs = {}
    with TournamentSpy():
        for label, mode, reset in (("online", "online", True),
                                   ("cached-first", "cached", False),
                                   ("cached", "cached", True)):
            if reset:
                backend.reset_process_state()
            cfg = config(2)
            cfg.codegen_tune_mode = mode
            cfg.codegen_tune_cache = cache
            ml = MLContext(cfg)
            lines = []
            ml.printer = lines.append
            before = tune.measurement_count()
            reset_launches(kernels)
            with PhaseTimer() as timer:
                beta = ml.execute(path_script("LinearRegCG", data)) \
                    .get_tensor("beta")
                torch.cuda.synchronize()
            iters = outer_iterations("LinearRegCG", lines)
            picks = {k: v for k, v in ml._stats.estim_counts.items()
                     if k.startswith("kb_")}
            mm = next((k[len("kb_pick_mmchain."):] for k in picks
                       if k.startswith("kb_pick_mmchain.")), None)
            rel = float(torch.linalg.norm(beta.double() - beta_true)
                        / torch.linalg.norm(beta_true))
            runs[label] = {
                "beta": beta, "iterations": iters, "mmchain_pick": mm,
                "measurements": tune.measurement_count() - before,
                "launches": read_launches(kernels), "kb": picks,
                "beta_rel_err": rel,
                "windows": phase_windows(timer, iters,
                                         f"[backend] LinearRegCG {label}")}
            if label == "cached":
                # again on the same MLContext: the region's graph replays,
                # as in the untuned main path's second run
                with PhaseTimer() as timer:
                    ml.execute(path_script("LinearRegCG", data)) \
                        .get_tensor("beta")
                    torch.cuda.synchronize()
                runs[label]["second_windows"] = phase_windows(
                    timer, iters, "[backend] LinearRegCG cached, again")
            print(f"[backend] LinearRegCG ({M}, {K}) fp32 optlevel 2, "
                  f"codegen_tune_mode {mode} ({label}): mmchain picks "
                  f"{mm}; {runs[label]['measurements']} measurements; "
                  f"launches {runs[label]['launches']}; kernel backend "
                  f"{picks}; |beta - beta_true| / |beta_true| = {rel:.3e}; "
                  f"{runs[label]['windows']['iteration_ms']:.3f} ms per CG "
                  f"iteration; on {smi}", flush=True)
        arms = _measured_arms("mmchain")
    with open(cache) as f:
        entries = json.load(f)["entries"]
    on, cached = runs["online"], runs["cached"]
    same_beta = bool(torch.equal(on["beta"], cached["beta"]))
    tuned_ms = {"first": cached["windows"]["iteration_ms"],
                "second": cached["second_windows"]["iteration_ms"]}
    print(f"[backend] mmchain key {[k for k in entries if k.startswith('mmchain|')]}"
          f": winner {on['mmchain_pick']} (online), {cached['mmchain_pick']} "
          f"(cached, {cached['measurements']} measurements); arms "
          + ", ".join(f"{n} median {a['median_ms']:.3f} ms over {a['n']} "
                      f"measurements" for n, a in arms.items())
          + f"; beta cached equals online bit for bit {same_beta}; ms per "
          f"CG iteration (the loop's device window over its iterations, "
          f"its first entry's peel and capture included) tuned against "
          f"untuned: first run {tuned_ms['first']:.3f} / "
          f"{untuned['first']:.3f}, second run {tuned_ms['second']:.3f} / "
          f"{untuned['second']:.3f}; on {smi}", flush=True)
    if cached["measurements"] != 0:
        fail(f"[backend] the cached run made {cached['measurements']} "
             f"measurements")
    if on["mmchain_pick"] is None or \
            cached["mmchain_pick"] != on["mmchain_pick"]:
        fail(f"[backend] the cached run picked {cached['mmchain_pick']}, "
             f"the online run {on['mmchain_pick']}")
    if not same_beta:
        fail("[backend] the cached run's beta differs from the online run's")
    if not cached["beta_rel_err"] <= 1e-3:
        fail(f"[backend] beta is {cached['beta_rel_err']} from beta_true")
    if on["measurements"] < 1:
        fail("[backend] the online run measured nothing")
    for r in runs.values():
        del r["beta"]

    # the compressed families at the Census shape, the quaternary ones on
    # ALS-CG-ml10m's V (CSR): analytic, then measured
    c = cla["LinearRegCG"]["auto"]["compressed"][0]
    gen = torch.Generator(device=dev).manual_seed(14)
    n, m = c.shape
    w = torch.randn(m, 1, generator=gen, device=dev)
    yt = torch.randn(1, n, generator=gen, device=dev)
    wy = torch.rand(n, 1, generator=gen, device=dev)
    cla_calls = {"cla_right": lambda: cla_dev.right_mult(c, w),
                 "cla_left": lambda: cla_dev.left_mult(c, yt),
                 "cla_mmchain": lambda: cla_dev.mmchain(c, w, wy, "XtwXv")}
    vs = SparseMatrix.from_dense(ratings)
    u = torch.rand(ML10M_USERS, 10, generator=gen, device=dev)
    vv = torch.rand(ML10M_MOVIES, 10, generator=gen, device=dev)
    q_calls = {
        "q_wsloss": lambda: mult.wsloss(vs, u, vv, None, "POST_NZ"),
        "q_wsigmoid": lambda: mult.wsigmoid(vs, u, vv, ""),
        "q_wdivmm": lambda: mult.wdivmm(vs, u, vv, False, False, 1e-3),
        "q_wcemm": lambda: mult.wcemm(vs, u, vv, 1e-3),
        "q_wumm": lambda: mult.wumm(vs, u, vv, "*", uop="exp")}
    verdicts = {}
    prev = get_config()
    set_config(config(2))
    try:
        with TournamentSpy():
            for label, calls in (("Census", cla_calls),
                                 ("ALS-CG-ml10m", q_calls)):
                ana = _kernel_verdicts(label, calls, "off")
                meas = _kernel_verdicts(label, calls, "online")
                for op in calls:
                    verdicts[op] = {"analytic": ana[op], "measured": meas[op],
                                    "arms": _measured_arms(op)}
                    print(f"[backend] {op} on {label}: analytic "
                          f"{ana[op]['choice']} (costs {ana[op]['analytic_s']}"
                          f" s), measured {meas[op]['choice']} "
                          f"({meas[op]['source']}; arms "
                          + ", ".join(f"{k} {a['median_ms']:.3f} ms x "
                                      f"{a['n']}" for k, a in
                                      _measured_arms(op).items())
                          + f"); key {ana[op]['key']}; on {smi}", flush=True)
    finally:
        set_config(prev)
    del vs, u, vv
    torch.cuda.empty_cache()
    return {"linregcg": runs, "mmchain_arms": arms,
            "cache_keys": sorted(entries), "tuned_iteration_ms": tuned_ms,
            "untuned_iteration_ms": untuned, "verdicts": verdicts}


REMOTE_PAR = 2
# the remote.job arrival the fault kills: each pass sends REMOTE_PAR jobs,
# so the 5th is the first job of the third pass (the first two spawn and
# reuse the pool without a fault)
REMOTE_KILL = "remote.job:kill:5"


def remote_phase(data, dev, kernels, smi) -> dict:
    """`[remote]`: StepGLM at the Census shape with its parfor in mode
    "remote" on REMOTE_PAR worker processes on the card (optlevel 3, as
    `[parfor-stepglm]`'s runs), one `remote.job` kill armed in its third
    pass (REMOTE_KILL). The selected set equal to the for run's and B
    within 1e-5 of it (the check `[parfor-stepglm]` makes), and B bit for
    bit the for run's: the killed worker's group is requeued on a fresh
    worker and the result does not move. Printed: s per stepwise pass,
    the first pass's spawn (each worker's start to READY) and payload s
    apart, the spawns of each later pass (the second spawns none: the
    pool is reused; the third one replacement), each worker's device.
    The pool is shut down at the end."""
    from systemml_tpu_torch.runtime import remote

    ref = data["stepglm_for"]
    loop = f'mode="remote", par={REMOTE_PAR}'
    passes = []
    orig = remote.run_remote

    def spy(pb, ec, tasks, k, body_reads):
        t0 = time.perf_counter()
        out = orig(pb, ec, tasks, k, body_reads)
        passes.append(dict(remote.last_run, pass_s=time.perf_counter() - t0))
        return out

    remote.run_remote = spy
    try:
        r = run_stepglm(data, 3, loop, dev, kernels, fault=REMOTE_KILL)
    finally:
        remote.run_remote = orig
        remote.shutdown_pool()
    diff = float(torch.linalg.norm(r["out"].double() - ref["B"].double())
                 / torch.linalg.norm(ref["B"].double()))
    same = bool(torch.equal(r["out"], ref["B"]))
    first = passes[0] if passes else {}
    spawns = [p.get("spawned") for p in passes]
    devices = sorted({d for p in passes for d in p["devices"]})
    print(f"[remote] StepGLM ({CENSUS_N}, {CENSUS_M}) optlevel 3 parfor mode "
          f"remote, par={REMOTE_PAR}, {REMOTE_KILL} armed: selected "
          f"{r['selected']}; {r['seconds']:.3f} s in all, {len(passes)} "
          f"passes of " + ", ".join(f"{p['pass_s']:.3f}" for p in passes)
          + f" s (local, one worker lane: 0.5071 s a pass); first pass: "
          f"payload {first.get('payload_s', 0):.3f} s, workers spawned "
          f"{first.get('spawned')}, start to READY "
          f"{[round(x, 3) for x in first.get('ready_s', [])]} s; spawns by "
          f"pass {spawns}; worker devices {devices}; resil {r['resil']}; "
          f"|B - B(for)| / |B(for)| = {diff:.3e} (bar 1e-5), B bit for bit "
          f"the for run's {same}; on {smi}", flush=True)
    if r["selected"] != ref["selected"]:
        fail(f"[remote] selected {r['selected']}, the for run "
             f"{ref['selected']}")
    if not diff <= 1e-5:
        fail(f"[remote] B is {diff} from the for run's")
    if len(passes) < 3 or r["stats"].get("parfor_remote_unshippable"):
        fail(f"[remote] the parfor ran remotely in {len(passes)} passes")
    if spawns[:3] != [REMOTE_PAR, 0, 1] or any(spawns[3:]):
        fail(f"[remote] spawns by pass {spawns}: the second pass did not "
             f"reuse the pool, or the kill was not replaced once")
    if devices != [torch.cuda.get_device_name(0)]:
        fail(f"[remote] workers ran on {devices}")
    if r["resil"].get("requeue") != 1 or not same:
        fail(f"[remote] the killed worker's group was not requeued once "
             f"({r['resil']}), or B moved")
    r["passes_remote"] = [dict(p) for p in passes]
    r["B_vs_for"], r["B_bit_identical_to_for"] = diff, same
    return {k: v for k, v in r.items() if k != "out"}


def _resnet_inputs(dev):
    """X (N, 3*224*224) fp32 on the card from a seeded generator, and the
    labels: every class 1 to 3 times, shuffled, with a planted class
    shift of 0.25 x (label mod 10) on every pixel (the manner of
    mnist_lenet.dml's generate_dummy_data)."""
    gen = torch.Generator(device=dev).manual_seed(18)
    y = np.arange(RESNET_N) % RESNET_K
    np.random.default_rng(18).shuffle(y)
    x = torch.randn(RESNET_N, 3 * 224 * 224, generator=gen, device=dev)
    x += 0.25 * torch.from_numpy(y % 10).to(dev, torch.float32)[:, None]
    return x, y


def _cross_entropy(probs: torch.Tensor, y: np.ndarray) -> float:
    idx = torch.from_numpy(np.asarray(y)).to(probs.device).long()
    p = probs.double().gather(1, idx[:, None])
    return float(-torch.log(p).mean())


def _run_script(clf, x, y, cfg, n, outputs, params=None):
    """The estimator's generated training script through MLContext on the
    first n rows (n / 64 steps), the one-hot labels over all of its
    classes: from its own initial weights, or from `params` (the init
    lines dropped, the weights bound as inputs)."""
    import re

    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.models import estimators
    from systemml_tpu_torch.ops import datagen

    src = clf.get_training_script()
    if params is not None:
        src = "\n".join(l for l in src.splitlines()
                        if not re.match(r"\[(W|G)\d+, .*::init\(", l))
    s = dml(src)
    s.base_dir = estimators._nn_base_dir()
    s.input("X", x[:n]).input("Y", estimators._one_hot(y[:n], clf.classes_))
    for k, v in clf.hyper.items():
        s.arg(k, v)
    for k, v in (params or {}).items():
        s.input(k, v)
    datagen.set_global_seed(int(clf.hyper["seed"]))
    try:
        return MLContext(cfg).execute(s.output(*outputs))
    finally:
        datagen.set_global_seed(None)


def _first_step_loss(clf, x, y, cfg, params=None) -> float:
    """The training loss of one step on the first batch: the cross entropy
    of that step's train-mode softmax (the script's probs_final)."""
    probs = _run_script(clf, x, y, cfg, RESNET_BS, ("probs_final",),
                        params).get_tensor("probs_final")
    return _cross_entropy(probs, np.searchsorted(clf.classes_,
                                                 y[:RESNET_BS]))


def _param_diff(a: dict, b: dict) -> tuple:
    """(every parameter bit-identical, the normwise difference of all
    parameters as one vector). One vector: a conv bias before a batch
    norm has an exactly-zero gradient, so its values are rounding noise
    that only the model's scale measures."""
    same, num, den = True, 0.0, 0.0
    for k in a:
        x, z = a[k].double(), b[k].double()
        same &= bool(torch.equal(a[k], b[k]))
        num += float(torch.sum((x - z) ** 2))
        den += float(torch.sum(z ** 2))
    return same, math.sqrt(num / max(den, 1e-300))


def _busy_over(prof, wall_ms: float) -> dict:
    """The union of the device intervals a CUDA-only profile recorded,
    over the run's wall time taken on the host around it (the two clocks
    differ, so only lengths are compared): the busy share of a run
    without a profiler range, with the number of intervals listed."""
    from torch.autograd import DeviceType

    ks = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    if not ks:
        return {"busy_share": "not measured", "kernels": 0}
    busy, end = 0.0, ks[0][0]
    for a, b in ks:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"busy_share": busy / 1e3 / wall_ms, "kernel_union_ms": busy / 1e3,
            "wall_ms": wall_ms, "kernels": len(ks)}


class Laps:
    """Host seconds between named points of a phase, for its last line."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = round(now - self.t, 2)
        self.t = now


def _update_diff(a: dict, b: dict, start: dict) -> float:
    """The normwise difference of two runs' updates from the same start,
    ||(a - start) - (b - start)|| / ||b - start||, all parameters as one
    vector: a gradient's fault shows against the update's own size, not
    against the parameters'."""
    num = den = 0.0
    for k in a:
        x, z, s0 = a[k].double(), b[k].double(), start[k].double()
        num += float(torch.sum((x - z) ** 2))
        den += float(torch.sum((z - s0) ** 2))
    return math.sqrt(num / max(den, 1e-300))


def _kernels_by_time(prof) -> list:
    """A profile's kernels, (name, calls, ms), the most device time
    first."""
    from torch.autograd import DeviceType

    acc = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = _kernel_name(e.name)
            ms, k = acc.get(name, (0.0, 0))
            acc[name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    return sorted(((nm, k, ms) for nm, (ms, k) in acc.items()),
                  key=lambda r: -r[2])


# the conv geometries the card's "auto" rules rest on (ops/dnn.py:
# CUDA_AUTO_LAYOUT, CUDA_AUTO_ALGO): (name, n, c, h, w, f, k, stride, pad)
CONV_RULE_GEOMS = (
    ("resnet stem", 64, 3, 224, 224, 64, 7, 2, 3),
    ("resnet s0 3x3", 64, 64, 56, 56, 64, 3, 1, 1),
    ("resnet s1 3x3/2", 64, 64, 56, 56, 128, 3, 2, 1),
    ("resnet s1 3x3", 64, 128, 28, 28, 128, 3, 1, 1),
    ("resnet s1 1x1/2", 64, 64, 56, 56, 128, 1, 2, 0),
    ("resnet s2 3x3", 64, 256, 14, 14, 256, 3, 1, 1),
    ("resnet s3 3x3", 64, 512, 7, 7, 512, 3, 1, 1),
    ("lenet conv1", 64, 1, 28, 28, 32, 5, 1, 2),
    ("lenet conv2", 64, 32, 14, 14, 64, 5, 1, 2))


def conv_rule_phase(dev, smi) -> dict:
    """Both conv arms ("conv": cuDNN; "im2col": unfold and one matmul) in
    both layouts (NCHW; NHWC as channels-last) at fp32 with TF32 off, at
    ResNet-18's and LeNet's geometries: CUDA events over back-to-back
    calls of the forward, the filter gradient and the data gradient
    (ms each, boundary-form inputs, so an NHWC run pays its transposes;
    5 calls a turn, two turns, after 2 warm calls).
    The times the card's "auto" rules in ops/dnn.py rest on; `--dnn`
    runs it, the full run does not (the rules are constants)."""
    from systemml_tpu_torch.ops import dnn
    from systemml_tpu_torch.utils.config import (apply_matmul_precision,
                                                 get_config, set_config)

    prev = get_config()
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    try:
        for name, n, c, h, w, f, k, s, p in CONV_RULE_GEOMS:
            x = torch.randn(n, c * h * w, generator=gen, device=dev)
            wt = torch.randn(f, c * k * k, generator=gen, device=dev)
            ho = dnn.out_dim(h, k, s, p)
            d = torch.randn(n, f * ho * ho, generator=gen, device=dev)
            args = ([n, c, h, w], [f, c, k, k], [s, s], [p, p])
            row = {}
            for algo in ("conv", "im2col"):
                for layout in ("nchw", "nhwc"):
                    cfg = config(2)
                    cfg.conv_algorithm, cfg.conv_layout = algo, layout
                    set_config(cfg)
                    apply_matmul_precision()
                    row[f"{algo},{layout}"] = time_ms([
                        lambda: dnn.conv2d(x, wt, *args),
                        lambda: dnn.conv2d_backward_filter(x, d, *args),
                        lambda: dnn.conv2d_backward_data(wt, d, *args)],
                        reps=5, warm=2)
            best = min(row, key=lambda r: sum(row[r]))
            out[name] = {"ms": row, "fastest": best}
            print(f"[conv-rule] {name} ({n}, {c}, {h}, {w}) x ({f}, {k}x{k}) "
                  f"s{s} p{p} fp32 on {smi}: ms forward / filter grad / "
                  f"data grad " + "; ".join(
                      f"{r} " + " / ".join(f"{v:.4f}" for v in t)
                      for r, t in row.items())
                  + f"; fastest in all three {best}", flush=True)
            del x, wt, d
    finally:
        set_config(prev)
    torch.cuda.empty_cache()
    return out


def resnet18_phase(dev, kernels, smi, control: bool = False) -> dict:
    """Caffe2DML(zoo.resnet18()).fit(X, y) on the card at optlevel 3, its
    training loop as a loop region: the first fit's seconds (parse,
    compile and nvcc, the init draw, the peel and the capture), a warm
    re-fit's ms per step and images/s and its busy share (torch.profiler),
    peak memory, region captures, launches and refusals, the conv
    algorithm and layout picks and transposes, K2/K4 launches, and
    predict_proba's ms per image over 256 images. Checks: the loss of
    the first batch falls from the initial weights to the trained ones;
    the fit with regions equals the fit without (bit for bit, or 1e-5
    normwise); two steps forced to conv_algorithm "im2col" update the
    learned parameters within 0.1 of cuDNN's update from the same start,
    normwise; under "bfloat16" the first step's loss is within 4e-2 of
    fp32's. With `control` (`--dnn`) the im2col check's own control
    runs too: the same two steps with im2col's filter gradient halved
    must fail the bar. The bar lies between the sound reading, about
    2e-2 of fp32 rounding, and the halved gradient's 0.5; in fp64 the two
    arms' updates agree to 1e-12, and the control runs at a small size on
    the CPU (tests/test_torch_models.py::test_conv_arms_update_alike).
    The busy share over the warm fit is printed as measured only when
    the profiler listed at least 90% as many kernels as the eager fit
    ran (it may not list a graph's). The last line gives the phase's
    host seconds by part."""
    from systemml_tpu_torch.models import Caffe2DML, zoo
    from systemml_tpu_torch.runtime import loopfuse
    from systemml_tpu_torch.utils.config import get_config, set_config

    x, y = _resnet_inputs(dev)
    steps = RESNET_N // RESNET_BS
    prev = get_config()
    out = {"n": RESNET_N, "batch": RESNET_BS, "steps": steps,
           "classes": RESNET_K, "input": [3, 224, 224], "card": smi}

    def fitted(cfg, precision="auto", clf=None):
        set_config(cfg)
        try:
            clf = clf or Caffe2DML(zoo.resnet18(), epochs=1,
                                   batch_size=RESNET_BS, seed=1,
                                   precision=precision)
            t0 = time.perf_counter()
            clf.fit(x, y)
            torch.cuda.synchronize()
            return clf, time.perf_counter() - t0
        finally:
            set_config(prev)

    cfg = config(3)
    laps = Laps()
    clf, first_s = fitted(cfg)
    laps("first fit")
    print(f"[resnet18] first fit (parse, compile, nvcc, init draw, peel, "
          f"capture, {steps} steps): {first_s:.2f} s", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    with PhaseTimer() as timer:
        clf, warm_s = fitted(cfg, clf=clf)
    launches = read_launches(kernels)
    # the loop's graph launch alone (device time; the init draw and the
    # loop's entry and exit outside it)
    graph_ms = sum(w[1] for w in timer.windows["launch"])
    graph_step_ms = graph_ms / steps
    peak = torch.cuda.max_memory_allocated(dev)
    stats = clf.fit_stats_
    regions = loopfuse.region_report(clf._fit_prog)
    ms_step = 1e3 * warm_s / steps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fitted(cfg, clf=clf)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0)
    busy = _busy_over(prof, prof_wall_ms)
    laps("warm and profiled fits")
    del prof
    dnn_counts = {k: v for k, v in stats.estim_counts.items()
                  if k.startswith("dnn_")}
    refusals = {r["label"]: r.get("refused") for r in regions
                if r.get("refused")}
    print(f"[resnet18] warm fit on {smi}: {warm_s:.3f} s, {ms_step:.2f} ms "
          f"per step (the init draw and the loop's entry and exit "
          f"included), {1e3 * RESNET_BS / ms_step:.1f} images/s; the "
          f"loop's graph {graph_ms:.2f} ms, {graph_step_ms:.3f} ms per "
          f"step, {1e3 * RESNET_BS / graph_step_ms:.1f} images/s, "
          f"{graph_ms / (1e3 * warm_s):.4f} of the warm fit (CUDA events); "
          f"peak allocated {peak / 1e9:.2f} GB; launches {launches}",
          flush=True)
    print(f"[resnet18] regions {regions}; refused {refusals}", flush=True)
    for line in stats.display().splitlines():
        if line.startswith(("DNN hot path", "  conv algorithms",
                            "Loop regions", "Spoof")):
            print(f"[resnet18] {line.strip()}", flush=True)
    trained = dict(clf.params)
    if not all(bool(torch.isfinite(v).all()) for v in trained.values()):
        fail("resnet18: the trained parameters are not finite")
    main = next((r for r in regions if r.get("entries")), None)
    if main is None or not main.get("captures") or refusals:
        fail(f"resnet18: the training loop did not run as a captured "
             f"region: {regions}")
    # predict_proba over 256 images (the second call timed)
    clf_p = clf
    set_config(cfg)
    try:
        clf_p.predict_proba(x[:256])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = clf_p.predict_proba(x[:256])
        pred_s = time.perf_counter() - t0
    finally:
        set_config(prev)
    if probs.shape != (256, RESNET_K) or not np.isfinite(probs).all() \
            or not np.allclose(probs.sum(1), 1.0, atol=1e-3):
        fail(f"resnet18: predict_proba gave {probs.shape}, not rows of "
             f"probabilities")
    # the first batch's training loss: initial weights against trained
    laps("predict")
    loss0 = _first_step_loss(clf, x, y, cfg)
    loss16 = _first_step_loss(clf, x, y, cfg, trained)
    print(f"[resnet18] predict_proba {1e3 * pred_s / 256:.4f} ms per image "
          f"over 256 images; first batch's training loss {loss0:.5f} at "
          f"the initial weights, {loss16:.5f} after {steps} steps",
          flush=True)
    if not (math.isfinite(loss0) and math.isfinite(loss16)
            and loss16 < loss0):
        fail(f"resnet18: the loss did not fall ({loss0} -> {loss16})")
    laps("first-step losses")
    # the same fit without regions (codegen_enabled False), profiled:
    # where the device time of a step goes, kernel by kernel
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eager, eager_s = fitted(config(3, regions=False))
    every = _kernels_by_time(prof)
    top = every[:15]
    kernel_ms = sum(r[2] for r in every)
    eager_kernels = sum(r[1] for r in every)
    del prof
    listed = busy.get("kernels", 0)
    if listed < 0.9 * eager_kernels:
        busy = {"busy_share": "not measured", "listed": listed,
                "eager_kernels": eager_kernels}
    print(f"[resnet18] busy share over the warm fit (torch.profiler): "
          f"{busy['busy_share']}; the profiler listed {listed} kernels "
          f"there, the eager fit ran {eager_kernels}", flush=True)
    print(f"[resnet18] where a step's device time goes (the eager fit's "
          f"kernels, profiler, init draw included: {kernel_ms:.1f} ms in "
          f"all, {kernel_ms / steps:.2f} a step): "
          + "; ".join(f"{nm} x{k} {ms:.2f} ms" for nm, k, ms in top),
          flush=True)
    same, diff = _param_diff(trained, eager.params)
    print(f"[resnet18] with regions / without: bit-identical {same}, "
          f"normwise {diff:.3e} (bar 1e-5); {ms_step:.2f} / "
          f"{1e3 * eager_s / steps:.2f} ms per step (the eager fit's "
          f"compile included)", flush=True)
    if not same and not diff <= 1e-5:
        fail(f"resnet18: the fit with regions is {diff} from the eager one")
    del eager
    laps("eager fit")
    # two steps forced to im2col against cuDNN, both from the trained
    # parameters: the updates of the learned parameters compared (the
    # batch norms' running statistics follow the forward, not a gradient,
    # and are printed apart)
    from systemml_tpu_torch.models import dmlgen
    from systemml_tpu_torch.ops import dnn

    names = dmlgen.param_names(clf.spec)
    learned = [n for n in names if not n.startswith("EMA")]

    def two_steps(c):
        r = _run_script(clf, x, y, c, 2 * RESNET_BS, names, trained)
        out = {n: r.get_tensor(n) for n in names}
        return ({n: out[n] for n in learned},
                {n: out[n] for n in names if n not in learned})

    c2, c2_ema = two_steps(cfg)
    cfg_i = config(3)
    cfg_i.conv_algorithm = "im2col"
    t0 = time.perf_counter()
    i2, i2_ema = two_steps(cfg_i)
    i2_s = time.perf_counter() - t0
    idiff = _update_diff(i2, c2, trained)
    ema_diff = _update_diff(i2_ema, c2_ema, trained)
    planted = "not run"
    if control:
        sound = dnn.conv2d_backward_filter
        dnn.conv2d_backward_filter = lambda *a, **k: 0.5 * sound(*a, **k)
        try:
            planted = _update_diff(two_steps(cfg_i)[0], c2, trained)
        finally:
            dnn.conv2d_backward_filter = sound
    print(f"[resnet18] 2 steps with conv_algorithm im2col against cuDNN, "
          f"from the same parameters: the learned parameters' updates "
          f"differ by {idiff:.3e} normwise (bar 0.1), with im2col's "
          f"filter gradient halved {planted}; the running statistics' "
          f"updates by {ema_diff:.3e}; {i2_s:.2f} s for the run, its "
          f"compile included", flush=True)
    if not idiff <= 0.1:
        fail(f"resnet18: im2col's update is {idiff} from cuDNN's")
    if control and not planted > 0.1:
        fail(f"resnet18: a halved filter gradient passes the im2col check "
             f"({planted})")
    del c2, i2
    laps("im2col against cuDNN")
    # the bfloat16 mixed policy
    bf, bf_first_s = fitted(cfg, precision="bfloat16")
    with PhaseTimer() as timer:
        bf, bf_s = fitted(cfg, precision="bfloat16", clf=bf)
    bf_graph_step = sum(w[1] for w in timer.windows["launch"]) / steps
    cfg_b = config(3)
    cfg_b.floating_point_precision = "bfloat16"
    loss_bf = _first_step_loss(bf, x, y, cfg_b)
    rel = abs(loss_bf - loss0) / abs(loss0)
    print(f"[resnet18] bfloat16 policy on {smi}: {1e3 * bf_s / steps:.2f} ms "
          f"per step warm, {RESNET_BS * steps / bf_s:.1f} images/s; the "
          f"loop's graph {bf_graph_step:.3f} ms per step "
          f"({1e3 * RESNET_BS / bf_graph_step:.1f} images/s); first "
          f"step's loss {loss_bf:.5f} against fp32's {loss0:.5f} "
          f"(relative {rel:.3e}, bar 4e-2)", flush=True)
    if not rel <= 4e-2:
        fail(f"resnet18: the bfloat16 first-step loss is {rel} from fp32's")
    del bf
    laps("bfloat16 fits")
    print(f"[resnet18] host seconds by part: {laps.s}", flush=True)
    out.update({"first_fit_s": first_s, "warm_fit_s": warm_s,
                "ms_per_step": ms_step, "graph_ms_per_step": graph_step_ms,
                "images_per_s": 1e3 * RESNET_BS / ms_step,
                "busy": busy, "eager_top_kernels": top,
                "eager_kernel_ms": kernel_ms, "peak_bytes": peak,
                "launches": launches,
                "regions": regions, "dnn_counts": dnn_counts,
                "predict_ms_per_image": 1e3 * pred_s / 256,
                "loss_first_batch": [loss0, loss16],
                "versus_eager": {"bit_identical": same, "normwise": diff},
                "im2col_update_normwise": idiff,
                "im2col_planted_fault": planted, "seconds": laps.s,
                "im2col_running_stats_normwise": ema_diff,
                "bf16": {"ms_per_step": 1e3 * bf_s / steps,
                         "graph_ms_per_step": bf_graph_step,
                         "first_fit_s": bf_first_s,
                         "first_step_loss": loss_bf, "fp32_loss": loss0}})
    torch.cuda.empty_cache()
    return out


def _lenet_data(dev, n, gen):
    """mnist_lenet.dml's generate_dummy_data at n rows: classes in 1..10,
    X = N(0, 1) + 0.25 x class on every pixel, Y one-hot."""
    cls = torch.randint(1, 11, (n,), generator=gen, device=dev)
    x = torch.randn(n, 784, generator=gen, device=dev) \
        + 0.25 * cls[:, None].float()
    yy = torch.nn.functional.one_hot(cls - 1, 10).float()
    return x, yy


def lenet_phase(dev, kernels, smi) -> dict:
    """scripts/nn/examples/mnist_lenet.dml's train() through MLContext at
    its widths: 6,400 rows, one epoch (100 iterations). Its inner loop is
    refused as "static_names" (end = min(N, beg + batch_size - 1)), as in
    the JAX package. The validation loss after the epoch must be below
    the loss at the initial weights, and the JMLC predict path scores."""
    from systemml_tpu_torch.api import jmlc
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.models import estimators
    from systemml_tpu_torch.ops import datagen

    gen = torch.Generator(device=dev).manual_seed(28)
    x, yy = _lenet_data(dev, LENET_N, gen)
    xv, yv = _lenet_data(dev, LENET_VAL, gen)
    base = estimators._nn_base_dir()

    def run(src, outs):
        from systemml_tpu_torch.obs import trace as obs

        s = dml(src)
        s.base_dir = base
        s.input("X", x).input("Y", yy).input("X_val", xv).input("Y_val", yv)
        ml = MLContext(config(2))
        lines = []
        ml.printer = lines.append
        datagen.set_global_seed(5)
        try:
            with obs.session() as rec:
                t0 = time.perf_counter()
                res = ml.execute(s.output(*outs))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            refused = sorted({e.args.get("reason") for e in rec.events()
                              if e.name == "loop_fallback"})
            return res, secs, lines, refused
        finally:
            datagen.set_global_seed(None)

    init, _, _, _ = run(LENET_INIT_SRC, ("loss",))
    loss0 = float(init.get_scalar("loss"))
    reset_launches(kernels)
    names = ("W1", "b1", "W2", "b2", "W3", "b3", "W4", "b4")
    res, secs, lines, refused = run(LENET_SRC,
                                    names + ("loss", "accuracy"))
    launches = read_launches(kernels)
    loss, acc = float(res.get_scalar("loss")), float(res.get_scalar(
        "accuracy"))
    iters = LENET_N // 64
    print(f"[lenet] train() one epoch of {iters} iterations at batch 64 on "
          f"{smi}: {secs:.3f} s, {1e3 * secs / iters:.3f} ms per iteration "
          f"(the epoch's validation predict of {LENET_VAL} rows, parse and "
          f"compile included); validation loss {loss0:.5f} at the initial "
          f"weights, {loss:.5f} after the epoch; accuracy {acc:.4f}; "
          f"printed {lines}; loops refused as regions: {refused} (the "
          f"JAX package's fused loop refuses the same); launches "
          f"{launches}", flush=True)
    if not (math.isfinite(loss) and loss < loss0):
        fail(f"lenet: the validation loss did not fall ({loss0} -> {loss})")
    if "static_names" not in refused:
        fail(f"lenet: train()'s inner loop was not refused as "
             f"static_names: {refused}")
    # JMLC: the predict function over the trained weights
    conn = jmlc.Connection()
    ps = conn.prepare_script(LENET_PREDICT, input_names=["X", *names],
                             output_names=["probs"], base_dir=base)
    params = {n: res.get_tensor(n) for n in names}
    t0 = time.perf_counter()
    probs = ps.execute({"X": xv, **params}).get_tensor("probs")
    torch.cuda.synchronize()
    jmlc_s = time.perf_counter() - t0
    jacc = float((probs.argmax(1) == yv.argmax(1)).double().mean())
    print(f"[lenet] JMLC predict of {LENET_VAL} rows: {1e3 * jmlc_s:.2f} ms, "
          f"accuracy {jacc:.4f} (chance 0.1)", flush=True)
    if not jacc > 0.1 or abs(jacc - acc) > 1e-6:
        fail(f"lenet: JMLC predict accuracy {jacc} (the script's {acc})")
    return {"iterations": iters, "seconds": secs,
            "ms_per_iteration": 1e3 * secs / iters, "loss": [loss0, loss],
            "accuracy": acc, "jmlc_accuracy": jacc, "launches": launches,
            "refused": refused, "card": smi}


# --------------------------------------------------------------------------
# the kernels at every shape their TPU kernels take: K1 past k = 2,048, K5
# past rank 32, K6 past the groups one block holds (`--shapes`)
# --------------------------------------------------------------------------

# ImageNet-1k's training images x VGG-16's fc7 width: a linear probe
K1_WIDE_M, K1_WIDE_K = 1_281_167, 4_096
K5_RANK = 100
# the Census rows with six times its columns, each of at most 8 values: at
# k = 1 more groups than one block of K6 holds (376 in fp32)
K6_GROUPS = 6 * CENSUS_M


def kernel_split(fn, reps: int = 5) -> dict:
    """Device ms per call of each kernel that `fn` launches, by name
    (torch.profiler, device activity only, over `reps` calls after one);
    "not measured" when the profiler records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    import re

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ids = [w for w in re.findall(r"([A-Za-z_]\w*)\s*[<(]", e.name)
                   if w not in ("void", "anonymous")]
            name = ids[0] if ids else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not out:
        return "not measured"
    return {k: round(val / reps, 4) for k, val in sorted(
        out.items(), key=lambda kv: -kv[1])}


def _fp64_chain_ref(x, v, rows: int = 100_000):
    """t(X) %*% (X %*% v) in fp64 on the card, X taken in row chunks (an
    fp64 copy of a 21 GB X would not fit beside it)."""
    out = torch.zeros(x.shape[1], v.shape[1], dtype=torch.float64,
                      device=x.device)
    vd = v.double()
    for r0 in range(0, x.shape[0], rows):
        xc = x[r0:r0 + rows].double()
        out += xc.T @ (xc @ vd)
        del xc
    return out


def _wide_cg_run(data, regions, dev, kernels) -> dict:
    """LinearRegCG at optlevel 2 on data["X"], after a warm-up on its first
    8,192 rows; the counters set to 0 just before and read just after."""
    from systemml_tpu_torch.api.mlcontext import MLContext

    ml = MLContext(config(2, regions))
    ml.printer = lambda s: None
    ml.execute(path_script("LinearRegCG", data, rows=8192))
    lines = []
    ml.printer = lines.append
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        beta = ml.execute(path_script("LinearRegCG", data)).get_tensor(
            "beta")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    iters = outer_iterations("LinearRegCG", lines)
    tag = f"k1-wide LinearRegCG{'' if regions else ' eager'}"
    windows = phase_windows(timer, iters, tag)
    reg = region_report(timer, tag, "LinearRegCG", regions)
    events = dict(ml._stats.estim_counts.items())
    return {"beta": beta, "iterations": iters, "seconds": secs,
            "launches": launches, "windows": windows, "regions": reg,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "kb_fallback": events.get("kb_fallback", 0),
            "kb_pick": {k: c for k, c in events.items()
                        if k.startswith("kb_pick_mmchain")}}


def _k1_tuned(data, kernels) -> dict:
    """LinearRegCG on the wide X with the tuner on, each run on a fresh
    kernel backend memo: "online" (measures, keeps nothing), then "cached"
    against a new temporary cache (measures, writes) and "cached" again
    (reads the verdict: no measurement). Each must pick K1; the last
    launches it once per CG iteration (the others also in their
    tournaments)."""
    from systemml_tpu_torch.api.mlcontext import MLContext
    from systemml_tpu_torch.codegen import backend, tune

    cache = os.path.join(tempfile.mkdtemp(prefix="smtorch-tune-"),
                         "tune.json")
    out = {}
    for label, mode, path in (("online", "online", ""),
                              ("cached-first", "cached", cache),
                              ("cached", "cached", cache)):
        backend.reset_process_state()
        cfg = config(2)
        cfg.codegen_tune_mode, cfg.codegen_tune_cache = mode, path
        ml = MLContext(cfg)
        lines = []
        ml.printer = lines.append
        before = tune.measurement_count()
        reset_launches(kernels)
        ml.execute(path_script("LinearRegCG", data)).get_tensor("beta")
        torch.cuda.synchronize()
        iters = outer_iterations("LinearRegCG", lines)
        picks = {k: c for k, c in ml._stats.estim_counts.items()
                 if k.startswith("kb_pick_mmchain") or k == "kb_fallback"}
        out[label] = {"picks": picks, "iterations": iters,
                      "measurements": tune.measurement_count() - before,
                      "launches": kernels.mmchain_kernel.launches}
        print(f"[k1-wide] tuner {label} (codegen_tune_mode {mode}): "
              f"{out[label]}", flush=True)
        # a measuring run also launches K1 in its tournament
        launched = out[label]["launches"]
        if picks.get("kb_pick_mmchain.kernel", 0) != 1 or \
                picks.get("kb_fallback", 0) or launched < iters or \
                (label == "cached" and launched != iters):
            fail(f"k1-wide tuner {label}: {out[label]}")
        if (out[label]["measurements"] == 0) != (label == "cached"):
            fail(f"k1-wide tuner {label}: {out[label]['measurements']} "
                 f"measurements")
    backend.reset_process_state()
    return out


def k1_wide_phase(dev, kernels, smi) -> dict:
    """[k1-wide]: LinearRegCG at 1,281,167 x 4,096 fp32 through MLContext,
    optlevel 2, with regions and without, and with the tuner's measured
    and cached verdicts; K1 against its plain version in fp64 and timed at
    the path's shape."""
    gen = torch.Generator(device=dev).manual_seed(20)
    m, k = K1_WIDE_M, K1_WIDE_K
    x = torch.randn(m, k, generator=gen, device=dev)
    beta_true = torch.randn(k, 1, generator=gen, device=dev)
    data = {"X": x, "y": x @ beta_true}
    x_bytes = x.numel() * 4
    print(f"[k1-wide] X ({m}, {k}) fp32, {x_bytes / 1e9:.3f} GB on the "
          f"card", flush=True)
    runs = {r: _wide_cg_run(data, r, dev, kernels) for r in (True, False)}
    bt = beta_true.double()
    out = {}
    for r, run in runs.items():
        rel = float(torch.linalg.norm(run["beta"].double() - bt)
                    / torch.linalg.norm(bt))
        label = "regions" if r else "eager"
        print(f"[k1-wide] LinearRegCG {label}: {run['iterations']} CG "
              f"iterations, {run['windows']['iteration_ms']:.3f} ms each, "
              f"{run['seconds']:.3f} s in all; launches {run['launches']}; "
              f"kb_fallback {run['kb_fallback']}, {run['kb_pick']}; "
              f"|beta - beta_true| / |beta_true| = {rel:.3e} (bar 1e-3); "
              f"peak allocated {run['peak_bytes'] / 1e9:.2f} GB", flush=True)
        if not rel <= 1e-3:
            fail(f"k1-wide {label}: beta is {rel} from beta_true")
        if run["launches"]["mmchain"] != run["iterations"] or \
                run["iterations"] < 1:
            fail(f"k1-wide {label}: K1 launched "
                 f"{run['launches']['mmchain']} times in "
                 f"{run['iterations']} CG iterations")
        if run["kb_fallback"]:
            fail(f"k1-wide {label}: kb_fallback {run['kb_fallback']}")
        out[label] = {kk: val for kk, val in run.items() if kk != "beta"}
        out[label]["beta_rel_err"] = rel
    if out["regions"]["launches"]["mmchain"] != \
            out["eager"]["launches"]["mmchain"]:
        fail("k1-wide: K1's launches differ with regions and without")
    del runs
    out["tuner"] = _k1_tuned(data, kernels)
    v = torch.randn(k, 1, generator=gen, device=dev)
    got = kernels.mmchain_kernel(x, v)
    again = kernels.mmchain_kernel(x, v)
    ref = _fp64_chain_ref(x, v)
    torch.cuda.synchronize()
    err = normwise(got, ref)
    abs_err = float((got.double() - ref).abs().max())
    same = bool(torch.equal(got, again))
    print(f"[kernel] mmchain XtXv m={m} k={k} c=1: normwise {err:.3e} (bar "
          f"{KERNEL_BAR:g}) against the plain version in fp64, max abs "
          f"{abs_err:.3e}, repeat bit-identical {same}", flush=True)
    if not (math.isfinite(err) and err <= KERNEL_BAR and same):
        fail(f"k1-wide: mmchain normwise {err}, repeat identical {same}")
    del got, again, ref
    kern_ms, plain_ms, lib_ms = time_ms([
        lambda: kernels.mmchain_kernel(x, v),
        lambda: kernels.mmchain_plain(x, v),
        lambda: torch.matmul(x.T, torch.matmul(x, v)),
    ], reps=10)
    nbytes = x_bytes + 2 * v.numel() * 4
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 4.0 * m * k / FP32_OPS_PER_S
    bound = max(bytes_ms, ops_ms)
    split = kernel_split(lambda: kernels.mmchain_kernel(x, v))
    print(f"[times] mmchain XtXv ({m}, {k}, 1) on {smi}: kernel "
          f"{kern_ms:.3f} ms, plain {plain_ms:.3f} ms, two torch.matmul "
          f"{lib_ms:.3f} ms, bound {bound:.3f} ms (bytes {bytes_ms:.3f}, "
          f"operations {ops_ms:.3f}): {bound / kern_ms:.1%} of the bound; "
          f"device ms by kernel (profiler) {split}", flush=True)
    out["kernel"] = {"shape": [m, k, 1], "launches": sum(
        out[r]["launches"]["mmchain"] for r in ("regions", "eager")),
        "max_abs_err": abs_err, "ms": kern_ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "bound_ms": bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "device_ms_by_kernel": split}
    del x, data, v
    torch.cuda.empty_cache()
    return out


def k5_rank_phase(ratings, dev, kernels, smi) -> dict:
    """[k5-rank100]: ALS-CG at rank 100 on the MovieLens-10M-shaped V,
    optlevel 3 (K5 once per outer iteration, no outer plan by the plain
    arm) against optlevel 2 (the loss within 1e-3); K5 against its plain
    version in fp64 and timed at that shape."""
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.config import get_config, set_config

    runs = {o: run_als(o, ratings, dev, kernels, rank=K5_RANK,
                       profile=False) for o in (3, 2)}
    loss_rel = abs(runs[3]["loss"] - runs[2]["loss"]) / abs(runs[2]["loss"])
    diffs = {nm: float(torch.linalg.norm(runs[3][nm].double()
                                         - runs[2][nm].double())
                       / torch.linalg.norm(runs[2][nm].double()))
             for nm in ("L", "R")}
    print(f"[k5-rank100] ALS-CG rank {K5_RANK}: loss optlevel 3 "
          f"{runs[3]['loss']:.6e}, optlevel 2 {runs[2]['loss']:.6e}, "
          f"relative {loss_rel:.3e} (bar 1e-3); |L3 - L2| / |L2| "
          f"{diffs['L']:.3e}, |R3 - R2| / |R2| {diffs['R']:.3e}; K5 "
          f"launches {runs[3]['launches']['spoof_outer']} in "
          f"{runs[3]['iterations']} outer iterations; ms per outer "
          f"iteration {runs[3]['windows']['iteration_ms']:.3f} / "
          f"{runs[2]['windows']['iteration_ms']:.3f}", flush=True)
    if not loss_rel <= 1e-3:
        fail(f"k5-rank100: optlevel 3's loss is {loss_rel} from optlevel 2's")
    old = get_config()
    set_config(config(3))
    try:
        s = als_script(None, K5_RANK)
        prog = compile_program(s.parse(), clargs=s._args, outputs=s._outputs,
                               input_names=list(s._inputs))
    finally:
        set_config(old)
    plan = _plan_of(prog, "outer").params["plan"]
    lf, rf = runs[3]["L"], runs[3]["R"]
    x = (ratings != 0).to(torch.float32)
    m, n = x.shape
    got = kernels.outer_kernel(plan, x, lf, rf, {})
    again = kernels.outer_kernel(plan, x, lf, rf, {})
    ref = kernels.outer_plain(plan, x.double(), lf.double(), rf.double(), {})
    torch.cuda.synchronize()
    rel = abs(float(got) - float(ref)) / abs(float(ref))
    abs_err = abs(float(got) - float(ref))
    same = bool(torch.equal(got, again))
    print(f"[kernel] spoof_outer {plan.pretty()} X ({m}, {n}) r={K5_RANK} "
          f"fp32: {float(got):.9e} against the plain version in fp64 "
          f"{float(ref):.9e}, relative {rel:.3e} (bar "
          f"{SPOOF_BARS[torch.float32]:g}), repeat bit-identical {same}",
          flush=True)
    if not (rel <= SPOOF_BARS[torch.float32] and same):
        fail(f"k5-rank100: K5 relative error {rel}, repeat identical {same}")
    del ref
    torch.cuda.empty_cache()
    kern_ms, plain_ms, mm_ms = time_ms([
        lambda: kernels.outer_kernel(plan, x, lf, rf, {}),
        lambda: kernels.outer_plain(plan, x, lf, rf, {}),
        lambda: torch.matmul(lf, rf.T),
    ], reps=10)
    nbytes = (x.numel() + lf.numel() + rf.numel()) * 4 + 4
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * (2.0 * K5_RANK + plan_ops(plan)) * m * n / FP32_OPS_PER_S
    bound = max(bytes_ms, ops_ms)
    split = kernel_split(lambda: kernels.outer_kernel(plan, x, lf, rf, {}))
    print(f"[times] spoof_outer X ({m}, {n}) r={K5_RANK} fp32 on {smi}: "
          f"kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms (bytes {bytes_ms:.4f}, operations {ops_ms:.4f}): "
          f"{bound / kern_ms:.1%} of the bound; yardstick "
          f"torch.matmul(U, V.T) alone {mm_ms:.4f} ms; device ms by kernel "
          f"(profiler) {split}", flush=True)
    del x
    torch.cuda.empty_cache()
    return {"loss_rel_diff": loss_rel, "diff_from_optlevel2": diffs,
            **{f"optlevel{o}": {kk: val for kk, val in r.items()
                                if kk not in ("L", "R", "LR", "cell_sums")}
               for o, r in runs.items()},
            "kernel": {"shape": [m, n, K5_RANK],
                       "launches": runs[3]["launches"]["spoof_outer"],
                       "max_abs_err": abs_err, "ms": kern_ms,
                       "plain_ms": plain_ms, "library_ms": None,
                       "yardstick_matmul_ms": mm_ms, "bound_ms": bound,
                       "bound_by": "bytes" if bytes_ms >= ops_ms
                       else "operations", "device_ms_by_kernel": split}}


def make_groups(dev, groups: int):
    """A categorical X (CENSUS_N, groups) as make_census draws it (column
    j takes d_j values, d_j in 2..8, column 0 all 8; dictionaries drawn
    N(0, 1) and standardised), its codes (CENSUS_N, groups) uint8 and
    dictionaries, and y = X beta_true + 0.01 noise; from one seeded
    generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(21)
    n = CENSUS_N
    dims = [8] + torch.randint(2, 9, (groups - 1,), generator=gen,
                               device=dev).tolist()
    x = torch.empty(n, groups, device=dev)
    codes = torch.empty(groups, n, dtype=torch.uint8, device=dev)
    dicts = []
    for j, d in enumerate(dims):
        dct = torch.randn(d, generator=gen, device=dev)
        dct = (dct - dct.mean()) / dct.std(correction=0)
        idx = torch.randint(0, d, (n,), generator=gen, device=dev)
        codes[j] = idx.to(torch.uint8)
        x[:, j] = dct[idx]
        dicts.append(dct)
    beta_true = torch.randn(groups, 1, generator=gen, device=dev)
    y = x @ beta_true + 0.01 * torch.randn(n, 1, generator=gen, device=dev)
    return {"X": x, "y": y, "codes": codes, "dicts": dicts, "dims": dims}


def compressed_of(data, rows=None):
    """The categorical X as a CompressedMatrixBlock of one DDC group per
    column (its codes and dictionary as drawn), on the host; its first
    `rows` rows when given."""
    from systemml_tpu_torch.compress import CompressedMatrixBlock
    from systemml_tpu_torch.compress import colgroup as cg

    codes = data["codes"] if rows is None else data["codes"][:, :rows]
    host = codes.cpu().numpy()
    groups = [cg.ColGroupDDC([j], d.cpu().numpy().reshape(-1, 1), host[j])
              for j, d in enumerate(data["dicts"])]
    return CompressedMatrixBlock(groups, (host.shape[1], len(groups)))


def _groups_cg_run(x, y, cla, dev, kernels, warm) -> dict:
    """LinearRegCG at optlevel 2 with `cla` on X (a compressed block or
    the dense X), after a warm-up on `warm` (X's first rows, y's); the
    counters set to 0 just before and read just after."""
    from systemml_tpu_torch.api.mlcontext import MLContext

    cfg = config(2)
    cfg.cla = cla
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    data = {"X": warm[0], "y": warm[1]}
    ml.execute(path_script("LinearRegCG", data))
    lines = []
    ml.printer = lines.append
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        beta = ml.execute(path_script("LinearRegCG", {"X": x, "y": y})
                          ).get_tensor("beta")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    iters = outer_iterations("LinearRegCG", lines)
    tag = f"k6-groups LinearRegCG cla={cla}"
    windows = phase_windows(timer, iters, tag)
    reg = region_report(timer, tag, "LinearRegCG", True)
    events = {k: c for k, c in ml._stats.estim_counts.items()
              if k.startswith(("cla_", "kb_pick_cla_", "kb_fallback"))}
    return {"beta": beta, "iterations": iters, "seconds": secs,
            "launches": launches, "windows": windows, "events": events,
            "regions": reg}


def k6_groups_phase(dev, kernels, smi) -> dict:
    """[k6-groups]: LinearRegCG with cla "true" on a categorical X of
    CENSUS_N rows and K6_GROUPS coded columns of at most 8 values (passed
    compressed: one DDC group per column, as drawn), against cla "false"
    on the dense X; K6 against its plain version in fp64 and timed at
    that shape, beside the gather arm."""
    from systemml_tpu_torch.compress import device as cla_dev

    data = make_groups(dev, K6_GROUPS)
    n, g = CENSUS_N, K6_GROUPS
    t0 = time.perf_counter()
    comp = compressed_of(data)
    warm_c = compressed_of(data, rows=65_536)
    build_s = time.perf_counter() - t0
    plan = cla_dev.chain_kernel_plan(8, g, 1, torch.float32)
    print(f"[k6-groups] categorical X ({n}, {g}) fp32, "
          f"{n * g * 4 / 1e9:.3f} GB dense, {g} DDC groups of "
          f"{min(data['dims'])}-{max(data['dims'])} values built on the host "
          f"from the card's codes in {build_s:.1f} s; K6's plan at k = 1 "
          f"(rows a tile, shared bytes, group slabs) {plan}", flush=True)
    if not plan[2]:
        fail(f"k6-groups: {g} groups at k = 1 fit one block: no slab path")
    warm_y = data["y"][:65_536]
    runs = {"true": _groups_cg_run(comp, data["y"], "true", dev, kernels,
                                   (warm_c, warm_y)),
            "false": _groups_cg_run(data["X"], data["y"], "false", dev,
                                    kernels, (data["X"][:65_536], warm_y))}
    a = runs["true"]["beta"].double()
    b = runs["false"]["beta"].double()
    diff = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    for cla, run in runs.items():
        print(f"[k6-groups] LinearRegCG cla={cla}: {run['iterations']} CG "
              f"iterations, {run['windows']['iteration_ms']:.3f} ms each, "
              f"{run['seconds']:.3f} s in all; launches {run['launches']}; "
              f"{run['events']}", flush=True)
    print(f"[k6-groups] |beta cla true - beta cla false| / |beta cla false| "
          f"= {diff:.3e} (bar 1e-3)", flush=True)
    t = runs["true"]
    if t["launches"]["cla_chain"] != t["iterations"] or t["iterations"] < 1:
        fail(f"k6-groups: K6 launched {t['launches']['cla_chain']} times in "
             f"{t['iterations']} CG iterations")
    if t["events"].get("cla_chain_plain_by_layout", 0):
        fail(f"k6-groups: cla_chain_plain_by_layout "
             f"{t['events']['cla_chain_plain_by_layout']}")
    if runs["false"]["launches"]["cla_chain"]:
        fail("k6-groups: cla false launched K6")
    if not diff <= 1e-3:
        fail(f"k6-groups: cla true is {diff} from cla false")
    lay = cla_dev.chain_layout(comp)
    gen = torch.Generator(device=dev).manual_seed(22)
    v = torch.randn(g, 1, generator=gen, device=dev)
    sv = cla_dev.chain_table(lay, v)
    _chain_case(f"k6-groups ({n}, {g}) XtXv k=1 fp32", lay.codes, sv, None,
                "XtXv")
    out = cla_dev.chain_kernel(lay.codes, sv)
    ref = cla_dev.chain_plain(lay.codes, sv.double())
    abs_err = float((out - ref).abs().max())
    del out, ref
    kern_ms, plain_ms, gather_ms, mm_ms = time_ms([
        lambda: cla_dev.chain_kernel(lay.codes, sv),
        lambda: cla_dev.chain_plain(lay.codes, sv),
        lambda: cla_dev.gather_mmchain(comp, v, None, "XtXv"),
        lambda: torch.matmul(data["X"].T, torch.matmul(data["X"], v)),
    ], reps=5, warm=1)
    nbytes = g * n + sv.numel() * 4 + 8 * sv.numel()
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    split = kernel_split(lambda: cla_dev.chain_kernel(lay.codes, sv))
    print(f"[times] cla_chain XtXv ({n}, {g}) k=1 fp32 on {smi}: device ms "
          f"by kernel (profiler) {split}")
    print(f"[times] cla_chain XtXv ({n}, {g}) k=1 fp32 on {smi}: kernel "
          f"{kern_ms:.4f} ms (z, then {plan[2]} group slabs), plain "
          f"{plain_ms:.4f} ms, the gather arm {gather_ms:.4f} ms, bound "
          f"{bound:.4f} ms (bytes: the codes once): {bound / kern_ms:.1%} of "
          f"the bound; yardstick two torch.matmul on the dense X "
          f"{mm_ms:.4f} ms", flush=True)
    res = {"diff_from_cla_false": diff, "plan": list(plan),
           "host_build_s": build_s,
           **{f"cla_{c}": {kk: val for kk, val in r.items() if kk != "beta"}
              for c, r in runs.items()},
           "kernel": {"shape": [n, g, 1], "launches": t["launches"][
               "cla_chain"], "max_abs_err": abs_err, "ms": kern_ms,
               "plain_ms": plain_ms, "gather_ms": gather_ms,
               "library_ms": None, "yardstick_matmul_ms": mm_ms,
               "bound_ms": bound, "bound_by": "bytes",
               "device_ms_by_kernel": split}}
    del data, comp, lay, sv
    torch.cuda.empty_cache()
    return res


def shapes_phase(ratings, dev, kernels, smi) -> dict:
    """[k1-wide], [k5-rank100] and [k6-groups], with their seconds."""
    out = {}
    for name, fn in (("k1-wide", lambda: k1_wide_phase(dev, kernels, smi)),
                     ("k5-rank100", lambda: k5_rank_phase(ratings, dev,
                                                          kernels, smi)),
                     ("k6-groups", lambda: k6_groups_phase(dev, kernels,
                                                           smi))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"[shapes] {name} {out[name]['seconds']:.1f} s", flush=True)
    return out


def shapes_only() -> None:
    """The kernels at the shapes past their old bounds alone: what
    `--shapes` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.codegen import build, kernels

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_plans((), KERNEL_SOURCES)
    print_build_reports(build)
    res = shapes_phase(make_ratings(dev), dev, kernels, smi)
    res["all_seconds"] = time.perf_counter() - t0
    print(json.dumps({"shapes": res}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.api.mlcontext import MLContext
    from systemml_tpu_torch.codegen import build, kernels
    from systemml_tpu_torch.codegen.compiler import hop_variant, program_plans

    # ---- 0. environment ---------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name!r}, count {torch.cuda.device_count()}")
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # true fp32 references
    t_start = time.perf_counter()
    data = make_data(dev)
    x = data["X"]
    x_bytes = x.numel() * x.element_size()

    # ---- 1. build ---------------------------------------------------------
    # the named sources build beside the paths' compiles (nvcc for
    # mmchain.cu takes longer than for any plan)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        named = pool.submit(build.build_plans, (), KERNEL_SOURCES)
        progs = compile_paths(data)
        als_progs = compile_als()
        compile_s = time.perf_counter() - t0
        for pname, prog in list(progs.items()) + list(als_progs.items()):
            for t in templates_of(prog):
                print(f"[plans] {pname} optlevel 3: {t[0]} {t[1]}: {t[2]}")
        built = build.build_plans(kernel_phase_sources(
            progs, als_progs, dev, kernels)) + named.result()
    build_s = time.perf_counter() - t0
    n_path_plans = len({(t, p.key(), v) for prog in list(progs.values())
                        + list(als_progs.values())
                        for t, p, v in program_plans(prog)})
    print(f"[build] compiled the paths, building their {n_path_plans} "
          f"fused plan sources, in {compile_s:.1f} s; the named sources and the "
          f"kernel phase's other plans ({len(built)} libraries) were built "
          f"by {build_s:.1f} s; one nvcc per source, "
          f"{len(build.build_reports)} in all")
    print_build_reports(build)
    from systemml_tpu_torch.codegen import loop_graph
    rt, drv = loop_graph.versions()
    print(f"[env] CUDA runtime {rt // 1000}.{rt % 1000 // 10} (loop_graph.cu's "
          f"build), driver {drv // 1000}.{drv % 1000 // 10}: conditional graph "
          f"nodes need 12.4", flush=True)
    loop_graph.check_versions()
    nvcc_by_path = {}
    for pname, prog in list(progs.items()) + list(als_progs.items()):
        # a library built by an earlier run of this checkout has no report
        secs = [build.build_reports.get(build.plan_source(*tpv)[0],
                                        (0.0, ""))[0]
                for tpv in program_plans(prog)]
        nvcc_by_path[pname] = {"sources": len(secs), "sum_s": sum(secs),
                               "max_s": max(secs, default=0.0)}
        print(f"[build] {pname}: {len(secs)} generated sources, nvcc "
              f"{sum(secs):.1f} s in all, {max(secs, default=0.0):.1f} s "
              f"for the slowest (the wall time of its program's parallel "
              f"build on a host with a core per source)")

    # ---- 2. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    max_abs_err = {}
    # (m, k, c, width of the matrix X is a column slice of, first column)
    for m, k, c, width, col0 in ((M, K, 1, K, 0), (100_003, K, 4, K, 0),
                                 (4_097, 128, 8, 128, 0),
                                 (100_003, K, 4, 1_004, 4),
                                 (4_097, 128, 8, 130, 1)):
        xk = x[:, :k] if (m, k, width) == (M, K, K) else \
            torch.randn(m, width, generator=gen, device=dev)[:, col0:col0 + k]
        v = torch.randn(k, c, generator=gen, device=dev)
        wcols = {"XtXv": 0, "XtwXv": 1, "XtXvy": c}
        xd = xk.double()
        for ctype, wc in wcols.items():
            w = (torch.randn(m, wc, generator=gen, device=dev)
                 if wc else None)
            out = kernels.mmchain_kernel(xk, v, w, ctype)
            again = kernels.mmchain_kernel(xk, v, w, ctype)
            ref = kernels.mmchain_plain(xd, v.double(),
                                        None if w is None else w.double(),
                                        ctype)
            torch.cuda.synchronize()
            err = normwise(out, ref)
            abs_err = float((out.double() - ref).abs().max())
            same = bool(torch.equal(out, again))
            print(f"[kernel] mmchain {ctype} m={m} k={k} c={c} "
                  f"w=({m},{wc}) X[:, {col0}:{col0 + k}] of width {width}: "
                  f"normwise {err:.3e} (bar {KERNEL_BAR:g}), "
                  f"max abs {abs_err:.3e}, repeat bit-identical {same}",
                  flush=True)
            if not math.isfinite(err) or err > KERNEL_BAR:
                fail(f"mmchain {ctype} at ({m}, {k}, {c}), width {width}: "
                     f"normwise error {err} > {KERNEL_BAR}")
            if not same:
                fail(f"mmchain {ctype} at ({m}, {k}, {c}), width {width}: "
                     f"two launches differ")
            if (m, k, c) == (M, K, 1) and ctype == "XtXv":
                max_abs_err["mmchain"] = abs_err
        del xk, v, xd, w, out, again, ref
    torch.cuda.empty_cache()
    max_abs_err.update(check_spoof_kernels(progs, dev, kernels))
    mask = check_masked_product(dev, kernels)
    max_abs_err["cla_chain"] = check_chain_kernel(dev)
    ratings = make_ratings(dev)
    n_ratings = int((ratings != 0).sum())
    print(f"[als] ratings V ({ML10M_USERS}, {ML10M_MOVIES}) fp32, "
          f"{ratings.numel() * 4 / 1e9:.3f} GB dense: {n_ratings} ratings "
          f"({100 * n_ratings / ratings.numel():.3f}% dense; MovieLens 10M "
          f"has {ML10M_RATINGS}), mean rating "
          f"{float(ratings.sum(dtype=torch.float64)) / n_ratings:.4f}",
          flush=True)
    check_outer_kernel(_plan_of(als_progs["ALS-CG"], "outer"), ratings, dev,
                       kernels, max_abs_err)
    check_multiagg_kernel(_plan_of(als_progs["summary"], "multiagg"),
                          ratings, progs, dev, kernels, max_abs_err)
    check_rand(dev)
    normal = check_normal(dev)
    poisson = check_poisson(dev)
    set_cond_rec = check_set_cond(dev)

    # ---- 2b. the region bridge on small scripts, card against CPU ---------
    bridge = bridge_phase(dev)

    # ---- 3. the paths -------------------------------------------------------
    audit = SyncAudit()
    # LinearRegCG at optlevel 2: the first slice's main path, K1
    lines = []

    def printer(s):
        lines.append(s)
        print(f"[script] {s}", flush=True)

    ml = MLContext()
    ml.printer = lambda s: None
    ml.execute(path_script("LinearRegCG", data, rows=8192))
    ml.printer = printer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        res = ml.execute(path_script("LinearRegCG", data))
        beta = res.get_tensor("beta")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    exec_secs = ml._stats.run_time
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    iters = outer_iterations("LinearRegCG", lines)
    beta_true = data["beta_true"]
    rel = float(torch.linalg.norm(beta.double() - beta_true.double())
                / torch.linalg.norm(beta_true.double()))
    print(f"[main] LinearRegCG {M} x {K} fp32 optlevel 2 on {beta.device}: "
          f"{iters} iterations, {secs:.3f} s total ({exec_secs:.3f} s "
          f"executing, the rest parse and compile), "
          f"{1e3 * exec_secs / max(iters, 1):.2f} ms of execution per CG "
          f"iteration (prologue and epilogue included)")
    print(f"[main] launches {launches}; |beta - beta_true| / |beta_true| = "
          f"{rel:.3e}; peak allocated {peak / 1e9:.2f} GB, X "
          f"{x_bytes / 1e9:.2f} GB", flush=True)
    if beta.shape != (K, 1) or not bool(torch.isfinite(beta).all()):
        fail(f"beta has shape {tuple(beta.shape)} or is not finite")
    if beta.dtype != torch.float32 or beta.device.type != "cuda":
        fail(f"beta is {beta.dtype} on {beta.device}, not fp32 on the card")
    if launches["mmchain"] != iters or iters < 1:
        fail(f"mmchain launched {launches['mmchain']} times in {iters} CG "
             f"iterations")
    if launches["spoof_cell"] or launches["spoof_row"]:
        fail("LinearRegCG at optlevel 2 launched spoof kernels")
    if not rel <= 1e-3:
        fail(f"beta is {rel} from beta_true (bar 1e-3)")
    if peak >= 2 * x_bytes:
        fail(f"peak device memory {peak} B >= 2 x X ({x_bytes} B): X was "
             f"copied")
    windows = {"first": phase_windows(timer, iters, "timed run")}
    main_regions = region_report(timer, "LinearRegCG optlevel 2 (main path)",
                                 "LinearRegCG", True)
    ml.printer = lambda s: None
    with PhaseTimer() as timer:
        ml.execute(path_script("LinearRegCG", data)).get_tensor("beta")
        torch.cuda.synchronize()
    ml.printer = printer
    windows["second"] = phase_windows(timer, iters, "second unprofiled run")
    main_path = {"iterations": iters, "seconds": secs,
                 "exec_seconds": exec_secs, "beta_rel_err": rel,
                 "peak_bytes": peak, "peak_reserved": peak_reserved,
                 "launches": launches, "windows": windows,
                 "regions": main_regions}
    del res
    # the CLI and io/: the same script from files, by python -m
    cli = cli_phase(data, beta, launches["mmchain"], dev)
    torch.cuda.empty_cache()
    main_path["profile"] = {
        "device_only": profile_main_path(
            ml, path_script("LinearRegCG", data), False),
        "host_and_device": profile_main_path(
            ml, path_script("LinearRegCG", data), True),
        "python_host_ms": host_profile(ml, path_script("LinearRegCG", data))}

    # this slice's paths: optlevel 3 (spoof fusion), then optlevel 2; each
    # runs its loops as regions (the default), and LinearRegCG at optlevel
    # 2 and MultiLogReg at 3 also without (codegen_enabled False)
    paths = {}
    eager_twins = {("LinearRegCG", 2): "mmchain_partial",
                   ("MultiLogReg", 3): "row_thread",
                   ("l2-svm", 3): None, ("l2-svm", 2): None}
    versus_eager = {}
    for pname in DENSE_PATHS:
        runs = {}
        for optlevel in (3, 2):
            if pname == "LinearRegCG" and optlevel == 2:
                runs[2] = {"out": beta, "iterations": iters,
                           "windows": windows["first"], "launches": launches,
                           "regions": main_regions, "peak_bytes": peak,
                           "peak_reserved": peak_reserved}
            else:
                runs[optlevel] = run_path(pname, optlevel, data, dev,
                                          kernels)
            if (pname, optlevel) in eager_twins:
                eag = run_path(pname, optlevel, data, dev, kernels,
                               regions=False,
                               profile_kernel=eager_twins[(pname, optlevel)])
                versus_eager[f"{pname} optlevel {optlevel}"] = compare_eager(
                    f"{pname} optlevel {optlevel}", runs[optlevel], eag)
                del eag
            if pname in PRINTS:
                check_print_lines(f"{pname} optlevel {optlevel}",
                                  runs[optlevel])
        a, b = runs[3]["out"].double(), runs[2]["out"].double()
        diff = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        print(f"[path] {pname}: |optlevel 3 - optlevel 2| / |optlevel 2| = "
              f"{diff:.3e} (bar 1e-3); outer iterations {runs[3]['iterations']}"
              f" / {runs[2]['iterations']}; ms per outer iteration "
              f"{runs[3]['windows']['iteration_ms']:.3f} / "
              f"{runs[2]['windows']['iteration_ms']:.3f}", flush=True)
        if not diff <= 1e-3:
            fail(f"{pname}: optlevel 3 is {diff} from optlevel 2")
        if pname == "LinearRegCG":
            r3 = float(torch.linalg.norm(a - beta_true.double())
                       / torch.linalg.norm(beta_true.double()))
            if not r3 <= 1e-3:
                fail(f"LinearRegCG optlevel 3: beta is {r3} from beta_true")
            if runs[3]["launches"]["mmchain"] != runs[3]["iterations"]:
                fail("LinearRegCG optlevel 3: mmchain did not launch once "
                     "per CG iteration")
        paths[pname] = {
            "diff_from_optlevel2": diff,
            "templates": templates_of(progs[pname]),
            **{f"optlevel{o}": {k: v for k, v in r.items()
                                if k not in ("out", "lines")}
               for o, r in runs.items()}}
        if pname == "LinearRegCG":
            paths[pname]["optlevel2"]["windows"] = windows
        del runs, a, b
    del beta
    torch.cuda.empty_cache()
    # the algorithm-breadth paths on the same X, and seq / sample on the
    # card against the CPU
    breadth = breadth_paths(data, dev, kernels)
    breadth_datagen = check_breadth_datagen(dev)
    torch.cuda.empty_cache()
    # this slice's path: minibatch SGD, slices at a device offset and a
    # loop-varying seed inside one graph
    minibatch = minibatch_paths(data, dev, kernels)
    torch.cuda.empty_cache()
    # this slice's path: LinearRegCG-cla (K6), and l2-svm on the same X
    cla = cla_paths(dev, kernels)
    torch.cuda.empty_cache()
    # this slice's paths: ALS-CG-ml10m (K5, K2) and the ratings summary (K3)
    als = als_paths(ratings, als_progs, dev, kernels)
    # the sparse plane: ALS-CG over a CSR V, MovieLens-10M- and
    # Netflix-shaped
    sparse = sparse_paths(ratings, als, dev, kernels)
    # this slice's paths on the Census shape: parfor on worker lanes
    # (StepGLM, categorical Univar-Stats), then frames and transform,
    # under the sync audit (per thread: each lane's entries against its
    # own calls)
    census = cla["data"]
    stepglm = stepglm_phase(census, dev, kernels, smi)
    univar = univar_phase(census, dev, kernels, smi)
    transform = transform_phase(census, dev, smi)
    syncs = audit.finish()
    torch.cuda.empty_cache()
    # this slice: the kernel backend's tuner on the main path and its
    # verdicts on the compressed and quaternary families; StepGLM's parfor
    # on worker processes
    backend = backend_phase(
        data, cla, ratings, dev, kernels, smi,
        {k: windows[k]["iteration_ms"] for k in ("first", "second")})
    remote = remote_phase(census, dev, kernels, smi)
    torch.cuda.empty_cache()
    # the buffer pool under pressure, the block compile's Kmeans, JMLC
    pool = pool_phase(data, dev)
    block_launches = {p: paths[p]["optlevel3"]["launches"] for p in paths}
    block_launches.update({p: breadth[p]["optlevel3"]["launches"]
                           for p in BREADTH_PATHS})
    block_launches["minibatch-sgd"] = minibatch["optlevel3"]["launches"]
    block_launches["ALS-CG-ml10m"] = als["optlevel3"]["launches"]
    block_launches["ALS-CG-ml10m-sparse"] = \
        sparse["ALS-CG-ml10m-sparse"]["regions"]["launches"]
    block_launches["ALS-CG-netflix"] = \
        sparse["ALS-CG-netflix"]["optlevel3"]["launches"]
    block = block_phase(breadth, block_launches)
    jmlc = jmlc_phase(data, dev)
    # this slice: the serving tier over the softmax scorer (K4)
    serving = serving_phase(data, dev, kernels, smi)
    torch.cuda.empty_cache()
    # this slice: the same scorer in three replica processes behind a
    # router, across a SIGKILL, a rolling update and an overload run
    fleet = fleet_phase(x[:SERVING_HOST_ROWS].cpu().numpy(), dev, kernels,
                        smi, serving)
    # this slice's paths: Caffe2DML ResNet-18 at 3x224x224 with 1,000
    # classes, and mnist_lenet's train() through MLContext
    resnet = resnet18_phase(dev, kernels, smi)
    lenet = lenet_phase(dev, kernels, smi)
    torch.cuda.empty_cache()
    # this slice: K1, K5 and K6 at the shapes past their old bounds
    shapes = shapes_phase(ratings, dev, kernels, smi)

    # ---- 4. times -----------------------------------------------------------
    v = torch.randn(K, 1, generator=gen, device=dev)
    kern_ms, plain_ms, lib_ms = time_ms([
        lambda: kernels.mmchain_kernel(x, v),
        lambda: kernels.mmchain_plain(x, v),
        lambda: torch.matmul(x.T, torch.matmul(x, v)),
    ])
    nbytes = x_bytes + 2 * v.numel() * v.element_size()  # X, v in; out
    bound_bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    bound_ops_ms = 1e3 * 4.0 * M * K / FP32_OPS_PER_S
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"[times] mmchain XtXv ({M}, {K}, 1) on {smi}: kernel "
          f"{kern_ms:.3f} ms, plain {plain_ms:.3f} ms, cuBLAS pair "
          f"{lib_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"(bytes {bound_bytes_ms:.3f}, operations {bound_ops_ms:.3f}); "
          f"{nbytes / kern_ms / 1e6:.1f} GB/s", flush=True)
    records = [{
        "name": "mmchain", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/mmchain.cu",
        "replaces": "systemml_tpu/codegen/kernels.py:347 mmchain_kernel",
        "launches": main_path["launches"]["mmchain"],
        "max_abs_err": max_abs_err["mmchain"],
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
        else "operations",
        "library_ms": lib_ms}]
    # this slice: the profiler on the main path, K1's rows against the
    # CUDA-event time just taken
    profile = profile_phase(data, dev, kernels, smi, kern_ms)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(3)
    by_path = {p: paths[p]["optlevel3"]["launches"] for p in paths}
    by_path.update({p: breadth[p]["optlevel3"]["launches"]
                    for p in BREADTH_PATHS})
    by_path["minibatch-sgd"] = minibatch["optlevel3"]["launches"]
    by_path["ALS-CG-ml10m"] = als["optlevel3"]["launches"]
    by_path["ALS-CG-ml10m-sparse"] = \
        sparse["ALS-CG-ml10m-sparse"]["regions"]["launches"]
    by_path["ALS-CG-netflix"] = sparse["ALS-CG-netflix"]["optlevel3"]["launches"]
    by_path["parfor-stepglm"] = stepglm["optlevel3"]["parfor"]["launches"]
    by_path["parfor-univar"] = univar["parfor"]["launches"]
    by_path["resnet18"] = resnet["launches"]
    by_path["lenet"] = lenet["launches"]
    by_path["serving"] = serving["launches"]
    # the survivors' counts, summed (the killed replica reports none)
    by_path["fleet"] = fleet["launches"]
    spoof_launches = {k: sum(c[k] for c in by_path.values())
                      for k in ("spoof_cell", "spoof_row")}
    replaces = {"spoof_cell": "systemml_tpu/codegen/kernels.py:124 "
                              "cell_kernel",
                "spoof_row": "systemml_tpu/codegen/kernels.py:199 "
                             "row_kernel"}
    for label, template, plan, names, hop in kernel_plans(progs)[:2]:
        env = kernel_env(label, hop, names, torch.float32, dev, gen)
        key = "spoof_cell" if template == "cell" else "spoof_row"
        if template == "cell":
            agg = "sum"
            fns = [lambda: kernels.cell_kernel(plan, names, agg, env),
                   lambda: kernels.cell_plain(plan, names, agg, env)]
            out_bytes, cells = 4, M
        else:
            agg = "sum"
            fns = [lambda: kernels.row_kernel(plan, names, agg, env),
                   lambda: kernels.row_plain(plan, names, agg, env)]
            out_bytes, cells = 4 * M, 5 * M
        call_ms, plain_call_ms = time_ms(fns, reps=50)
        k_ms, p_ms = device_ms(fns[0]), device_ms(fns[1])
        cold_ms = device_ms(fns[0], cold=True)
        b_ms, b_by = spoof_bound(plan, env, out_bytes, cells)
        print(f"[times] {key} {agg} {label} fp32 on {smi}: device time "
              f"per call (profiler) kernel {cold_ms:.4f} ms with the L2 "
              f"cache evicted before each call (the record's ms: the bound "
              f"counts bytes from device memory), {k_ms:.4f} ms with the "
              f"inputs left in L2 by the call before, plain (the "
              f"unfused torch sequence, L2 left as it is) {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms "
              f"({b_by}, bytes from device memory); back-to-back calls by "
              f"CUDA events (host-bound "
              f"where the call's host time is longer) kernel "
              f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; no single "
              f"torch call computes a fused plan", flush=True)
        records.append({
            "name": key, "route": "cuda",
            "source": "systemml_tpu_torch/codegen/csrc/spoof.cuh",
            "replaces": replaces[key], "launches": spoof_launches[key],
            "launches_by_path": {p: c[key] for p, c in by_path.items()},
            "max_abs_err": max_abs_err[key], "ms": cold_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "warm_l2_ms": k_ms, "call_ms": call_ms,
            "plain_call_ms": plain_call_ms, "plan": plan.pretty()})
        del env
    records[1].update(time_cell_beyond_l2svm(als, ratings, als_progs, smi,
                                             kernels))
    # K4 at minibatch-sgd's own shape: 2,000 of its launches are that
    # row plan at a 1,000-row batch
    label, _, plan, names, hop = kernel_plans(progs)[5]
    env = kernel_env(label, hop, names, torch.float32, dev, gen)
    bs = PATHS["minibatch-sgd"][2]["bs"]
    mb_ms = device_ms(lambda: kernels.row_kernel(plan, names, "sum", env),
                      cold=True)
    mb_plain = device_ms(lambda: kernels.row_plain(plan, names, "sum", env))
    mb_bound, mb_by = spoof_bound(plan, env, 4 * bs, 5 * bs)
    print(f"[times] spoof_row sum {label} ({bs}, 5) fp32 on {smi}: device "
          f"time per call {mb_ms:.4f} ms with the L2 cache evicted, plain "
          f"{mb_plain:.4f} ms, bound {mb_bound:.5f} ms ({mb_by})", flush=True)
    records[2].update({"minibatch_ms": mb_ms, "minibatch_plain_ms": mb_plain,
                       "minibatch_bound_ms": mb_bound,
                       "minibatch_bound_by": mb_by,
                       "serving": serving["k4_serving"],
                       "fleet": fleet["k4_fleet"]})
    del env
    records.append(time_chain_kernel(cla, dev, smi, max_abs_err))
    left_mult = time_left_mult(cla, dev, smi)
    records.append({
        "name": "set_cond", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/loop_graph.cu",
        "replaces": "none: systemml_tpu/runtime/loopfuse.py:379 "
                    "_trace_while (lax.while_loop's cond, no pallas_call)",
        "launches": main_path["launches"]["set_cond"],
        "max_abs_err": set_cond_rec["max_abs_err"], "ms": set_cond_rec["ms"],
        "plain_ms": set_cond_rec["plain_ms"],
        # one predicate element read, nothing written
        "bound_ms": 1e3 * 1 / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": None,
        "note": "ms: a WHILE loop's control per iteration inside one graph "
                "(counter add, compare, set_cond); plain_ms: the same loop "
                "driven from the host"})
    records.extend(time_outer_and_multiagg(als, ratings, als_progs, smi,
                                           max_abs_err, kernels))
    records[-2]["launches_by_path"] = {p: c["spoof_outer"]
                                       for p, c in by_path.items()}
    # the host time of one spoof wrapper call (a tiny input: the launch,
    # not the work); hops/cost.py HwProfile.h100().dispatch_us
    _, _, svm_plan, svm_names, svm_hop = kernel_plans(progs)[0]
    # one slice per variable: a variable named twice is one object, as on
    # the paths
    svm_full = kernel_env("l2-svm cell", svm_hop, svm_names, torch.float32,
                          dev, gen)
    small = {id(t): (t[:1024] if t.ndim == 2 else t)
             for t in svm_full.values()}
    svm_env = {nm: small[id(t)] for nm, t in svm_full.items()}
    svm_variant = hop_variant(svm_hop)
    summ = _plan_of(als_progs["summary"], "multiagg")
    s_names = list(summ.params["leaf_names"])
    tv = torch.rand(64, 64, device=dev)
    s_env = {s_names[0]: tv, s_names[1]: tv, s_names[2]: tv.sum(),
             s_names[3]: (tv != 0).sum().to(torch.float32)}
    plan0, names0 = kernel_plans(progs)[1][2], ["i0", "i1"]
    tiny = {"i0": torch.randn(1024, 5, device=dev),
            "i1": torch.randn(1024, 1, device=dev)}
    dispatch_us, _ = host_us({
        "row": lambda: kernels.row_kernel(plan0, names0, "sum", tiny),
        "cell_sum": lambda: kernels.cell_kernel(svm_plan, svm_names, "sum",
                                                svm_env),
        "cell_sum_hop_variant": lambda: kernels.cell_kernel(
            svm_plan, svm_names, "sum", svm_env, svm_variant),
        "multiagg": lambda: kernels.multiagg_kernel(
            summ.params["plan"], s_names, summ.params["aggs"], s_env)})
    print(f"[dispatch] host time of one spoof wrapper call: row on (1024, "
          f"5) {dispatch_us['row']:.2f} us, cell sum of l2-svm's plan on "
          f"(1024, 1) {dispatch_us['cell_sum']:.2f} us (with the hop's "
          f"Variant, as the path calls it, "
          f"{dispatch_us['cell_sum_hop_variant']:.2f} us), multi-aggregate "
          f"of the summary's plan on (64, 64) {dispatch_us['multiagg']:.2f} "
          f"us; "
          f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # the shapes phase's launches added to K1's, K5's and K6's, and each
    # kernel's figures at its path's shape
    for rec in records:
        key = {"mmchain": "k1-wide", "spoof_outer": "k5-rank100",
               "cla_chain": "k6-groups"}.get(rec["name"])
        if key:
            kr = shapes[key]["kernel"]
            rec.setdefault("launches_by_path", {})[key] = kr["launches"]
            rec["launches"] += kr["launches"]
            rec["shapes"] = {key: kr}
    cla_summary = {
        name: {mode: {k: v for k, v in r.items()
                      if k not in ("out", "compressed", "lines")}
               for mode, r in cla[name].items()}
        for name in ("LinearRegCG", "l2-svm")}
    print(json.dumps({"kernels": records, "card": smi,
                      "versus_eager": versus_eager, "bridge": bridge,
                      "spoof_dispatch_us": dispatch_us, "main_path": main_path,
                      "paths": paths, "cla_paths": cla_summary,
                      "als_paths": {k: r for k, r in als.items()
                                    if k not in ("factors", "cell_sums")},
                      "sparse_paths": {
                          p: {m: ({k: x for k, x in r.items()
                                   if k not in ("L", "R")}
                                  if isinstance(r, dict) else r)
                              for m, r in runs.items()}
                          for p, runs in sparse.items()},
                      "breadth_paths": breadth,
                      "minibatch_sgd": minibatch,
                      "cla_left_mult": left_mult, "region_syncs": syncs,
                      "breadth_datagen": breadth_datagen,
                      "cli": cli, "pool": pool, "block": block,
                      "jmlc": jmlc, "serving": serving, "fleet": fleet,
                      "masked_product": mask, "profile": profile,
                      "parfor_stepglm": stepglm,
                      "parfor_univar": univar, "transform": transform,
                      "resnet18": resnet, "lenet": lenet,
                      "normal_draw": normal, "poisson_draw": poisson,
                      "backend": backend, "remote_parfor": remote,
                      "shapes": shapes,
                      "build_seconds": build_s,
                      "nvcc_by_path": nvcc_by_path,
                      "device_ms_fallbacks": DEVICE_MS_FALLBACKS}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def check_masked_product(dev, kernels) -> dict:
    """K2's fused functor on `X * (X > 0)` as the compiler writes it (a
    b(*) by a mask of the same block: op_mask_mul) over NaN, +-Inf and
    negative cells, fp32 and fp64, elementwise and summed, against its
    plain arm: +0 without a sign bit at every masked cell, as the JAX
    package's select (ROADMAP queue 3, fault 1)."""
    from systemml_tpu_torch.codegen.cplan import CNode, emit_cuda

    leaf = CNode("in", name="i0")
    plan = CNode("b(*)", [leaf, CNode("b(>)", [leaf,
                                               CNode("lit", value=0.0)])],
                 value=1)
    if "op_mask_mul" not in emit_cuda(plan, ["i0"]):
        fail(f"[mask] the functor of {plan.pretty()} is "
             f"{emit_cuda(plan, ['i0'])}, not op_mask_mul")
    gen = torch.Generator(device=dev).manual_seed(17)
    out_rec = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.randn(M // 8, 8, generator=gen, device=dev, dtype=dtype)
        x[::7, 0] = float("nan")
        x[1::11, 1] = float("inf")
        x[2::13, 2] = float("-inf")
        env = {"i0": x}
        got = kernels.cell_kernel(plan, ["i0"], None, env)
        total = kernels.cell_kernel(plan, ["i0"], "sum", env)
        ref = kernels.cell_plain(plan, ["i0"], None, env)
        ref_sum = kernels.cell_plain(plan, ["i0"], "sum",
                                     {"i0": x.double()})
        torch.cuda.synchronize()
        masked = ~(x > 0)
        n_masked = int(masked.sum())
        plus_zero = bool((got[masked] == 0).all()) and not bool(
            torch.signbit(got[masked]).any())
        same = bool(torch.equal(got, ref))
        ieee_nan = int((x * (x > 0).to(dtype)).isnan().sum())
        # +Inf cells are not masked: both sums are +Inf, or both finite
        rel = (0.0 if float(total) == float(ref_sum) else
               abs(float(total) - float(ref_sum)) / abs(float(ref_sum)))
        print(f"[mask] K2 op_mask_mul {tuple(x.shape)} {str(dtype)[6:]}: "
              f"{n_masked} masked cells all +0 without a sign bit "
              f"{plus_zero} (the IEEE product has {ieee_nan} NaN there); "
              f"equal to the plain arm {same}; sum {float(total):.6e} vs "
              f"fp64 plain {float(ref_sum):.6e} (rel {rel:.2e})",
              flush=True)
        if not plus_zero or not same or bool(got.isnan().any()):
            fail(f"[mask] {dtype}: masked cells +0 {plus_zero}, equal to "
                 f"the plain arm {same}")
        if not rel <= SPOOF_BARS[dtype] * 100:
            fail(f"[mask] {dtype}: the sum is {rel} from the plain arm's")
        out_rec[str(dtype)[6:]] = {"masked_cells": n_masked,
                                   "plus_zero": plus_zero, "equal": same,
                                   "sum_rel": rel}
        del x, got, ref
    return out_rec


def _profiled_run(name, optlevel, data, kernels, mode, regions=True,
                  args=None, record=True):
    """One run of a path through MLContext after a warm run on the same
    data, under profile_mode `mode`, recorded (`record`) or not; returns
    the recorder (None), the report, the launch counters of the run, the
    regions' records and the output."""
    from systemml_tpu_torch import obs
    from systemml_tpu_torch.api.mlcontext import MLContext
    from systemml_tpu_torch.obs import profile as prof
    from systemml_tpu_torch.runtime import loopfuse
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    cfg = config(optlevel, regions)
    cfg.profile_mode = mode
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    ml.execute(path_script(name, data, args=args))
    torch.cuda.synchronize()
    prof.reset_sampling()
    reset_launches(kernels)
    with PhaseTimer() as timer:
        with (obs.session() if record else contextlib.nullcontext()) as rec:
            out = ml.execute(path_script(name, data, args=args)) \
                .get_tensor(PATHS[name][3])
        torch.cuda.synchronize()
    launches = read_launches(kernels)
    regions_rec = [{k: r.get(k) for k in ("label", "entries", "launches",
                                          "host_syncs", "trips")}
                   for r in loopfuse.region_report(timer.program)]
    rep = None
    if rec is not None:
        set_config(cfg)
        try:
            rep = obs.profile_report(rec)
        finally:
            set_config(DMLConfig())
    if not bool(torch.isfinite(out).all()):
        fail(f"[profile] {name} optlevel {optlevel} {mode}: output not "
             f"finite")
    return rec, rep, launches, regions_rec, out, ml._stats


def span_breakdown(rec, top: int = 12) -> list:
    """The run's exclusive span time by (bucket, span name, its mode,
    region or block), largest first, in ms: where each bucket's time
    went."""
    from systemml_tpu_torch.obs.profile import _bucket_of

    spans = [e for e in rec.events() if e.ph == "X"]
    ids = {e.id for e in spans}
    child = {}
    for e in spans:
        if e.parent in ids:
            child[e.parent] = child.get(e.parent, 0) + e.dur
    acc = {}
    for e in spans:
        a = e.args or {}
        key = (_bucket_of(e), e.name, str(a.get("mode") or a.get("region")
                                          or a.get("block") or a.get("kind")
                                          or ""))
        acc[key] = acc.get(key, 0.0) + (e.dur - child.get(e.id, 0)) / 1e6
    return sorted(([*k, round(v, 3)] for k, v in acc.items()),
                  key=lambda r: -r[3])[:top]


def profile_phase(data, dev, kernels, smi, k1_ms: float) -> dict:
    """[profile]: LinearRegCG at 2,000,000 x 1,000 fp32, optlevel 2 (K1),
    under profile_mode "full": with regions (each while entry one graph
    launch) and as the [eager] configuration (codegen_enabled False: each
    K1 launch a kernel_launch row); l2-svm at optlevel 3 (K2's rows, its
    functor with op_mask_mul). The bucket seconds and named coverage
    (bar 0.95, the JAX package's, on LinearRegCG with regions over 40
    CG iterations, tol 0), the region rows against dispatch_stats, each
    kernel row's device ms a launch and roofline_frac (K1's within 10% of
    `k1_ms`, the CUDA-event time of phase 4), ingest_profile; "off" with a
    recorder against no recorder (launches, host syncs per while entry)
    and "sample" against "off" (dispatch counts); -profile and -trace by
    the CLI; PreparedScript.set_trace on the softmax scorer."""
    from systemml_tpu_torch import obs
    from systemml_tpu_torch.codegen import costmodel

    out = {"card": smi}
    long_args = {"tol": 0, "maxi": 40}
    rows = {}
    for tag, name, optlevel, regions, args in (
            ("LinearRegCG regions", "LinearRegCG", 2, True, long_args),
            ("LinearRegCG regions, path args", "LinearRegCG", 2, True, None),
            ("LinearRegCG eager", "LinearRegCG", 2, False, long_args),
            ("l2-svm optlevel 3", "l2-svm", 3, True, None)):
        rec, rep, launches, regs, _, st = _profiled_run(
            name, optlevel, data, kernels, "full", regions, args)
        ds = obs.dispatch_stats(rec)
        b = {k: round(v, 6) for k, v in rep.buckets.items()}
        top = span_breakdown(rec)
        print(f"[profile] {tag} on {smi}: wall {rep.wall_s:.4f} s, named "
              f"coverage {rep.coverage:.4f}, buckets s {b}; dispatches "
              f"{rep.total_dispatches} ({rep.fenced_dispatches} fenced); "
              f"region trips {[r['trips'] for r in regs]}; exclusive ms "
              f"by span {top}", flush=True)
        for label, r in sorted(rep.regions.items()):
            want = (ds.get("loop_regions") or {}).get(label, {}).get(
                "dispatches")
            print(f"[profile] {tag} row {label}: {r['count']} dispatches "
                  f"(dispatch_stats {want}), device {r['device_s']:.4f} s",
                  flush=True)
            if want is not None and want != r["count"]:
                fail(f"[profile] {tag} {label}: {r['count']} dispatches, "
                     f"dispatch_stats {want}")
        if set(l for l in rep.regions if l.startswith("while[")) != \
                set(st.region_counts):
            fail(f"[profile] {tag}: region rows {sorted(rep.regions)} are "
                 f"not -stats' {sorted(st.region_counts)}")
        krows = {}
        for key, r in sorted(rep.kernels.items()):
            per = 1e3 * r["device_s"] / r["count"]
            rf = r.get("roofline_frac")
            krows[key] = {"count": r["count"], "ms_per_launch": per,
                          "roofline_frac": rf,
                          "modeled_ms": 1e3 * r.get("modeled_s", 0.0)}
            print(f"[profile] {tag} kernel {key}: {r['count']} launches, "
                  f"{per:.4f} ms a launch, roofline_frac "
                  f"{'-' if rf is None else f'{rf:.4f}'}", flush=True)
            if rf is not None and not rf <= 1.0:
                fail(f"[profile] {tag} {key}: roofline_frac {rf} > 1")
        n_ingested = costmodel.ingest_profile(rep)
        print(f"[profile] {tag}: ingest_profile took {n_ingested} rows",
              flush=True)
        rows[tag] = {"wall_s": rep.wall_s, "coverage": rep.coverage,
                     "by_span_ms": top,
                     "buckets_s": rep.buckets, "regions": rep.regions,
                     "kernels": krows, "launches": launches,
                     "region_records": regs, "ingested": n_ingested,
                     "dispatches": ds["dispatches"]}
        if tag == "LinearRegCG regions" and not rep.coverage >= 0.95:
            fail(f"[profile] {tag}: named coverage {rep.coverage} < 0.95:\n"
                 f"{rep.text()}")
        if tag == "LinearRegCG eager":
            k1 = [r for k, r in rep.kernels.items()
                  if k.startswith("mmchain.kernel")]
            n = sum(r["count"] for r in k1)
            if n != launches["mmchain"] or n < 1:
                fail(f"[profile] eager: K1 rows count {n}, its counter "
                     f"{launches['mmchain']}")
            per = 1e3 * sum(r["device_s"] for r in k1) / n
            rel = per / k1_ms - 1.0
            print(f"[profile] eager K1: {per:.4f} ms a launch in its rows "
                  f"against {k1_ms:.4f} ms by CUDA events (phase 4): "
                  f"{100 * rel:+.2f}% (bar 10%)", flush=True)
            rows[tag]["k1_vs_events"] = rel
            if not abs(rel) <= 0.10:
                fail(f"[profile] eager K1 row {per} ms vs {k1_ms} ms")
            if not all(r.get("roofline_frac") is not None for r in k1):
                fail("[profile] eager: K1's row has no roofline_frac")
            if n_ingested < 1:
                fail("[profile] eager: ingest_profile took no row")
        if tag == "l2-svm optlevel 3" and not any(
                k.startswith("spoof_cell.") for k in rep.kernels):
            fail(f"[profile] l2-svm: no K2 row in {sorted(rep.kernels)}")
        del rec, rep
    out["runs"] = rows
    # "off" with a recorder against none; "sample" against "off"
    _, _, l_none, r_none, _, _ = _profiled_run(
        "LinearRegCG", 2, data, kernels, "off", record=False)
    rec_off, _, l_off, r_off, _, _ = _profiled_run(
        "LinearRegCG", 2, data, kernels, "off")
    rec_smp, rep_smp, l_smp, r_smp, _, _ = _profiled_run(
        "LinearRegCG", 2, data, kernels, "sample")
    off_events = [e.name for e in rec_off.events()
                  if e.name in ("host_sync", "kernel_launch")
                  or (e.args or {}).get("fenced")]
    d_off = obs.dispatch_stats(rec_off)["dispatches"]
    d_smp = obs.dispatch_stats(rec_smp)["dispatches"]
    print(f"[profile] off with a recorder / none: launches {l_off} / "
          f"{l_none}; regions {r_off} / {r_none}; profiler events under "
          f"off {len(off_events)}; sample / off dispatches {d_smp} / "
          f"{d_off} ({rep_smp.fenced_dispatches} fenced), launches "
          f"{l_smp}", flush=True)
    if l_off != l_none or r_off != r_none or off_events:
        fail("[profile] profile_mode off with a recorder changed the run")
    if d_smp != d_off or l_smp != l_off or \
            not 0 < rep_smp.fenced_dispatches <= rep_smp.total_dispatches:
        fail("[profile] sample changed the dispatch counts")
    out["off_vs_none"] = {"launches": l_off, "regions": r_off,
                          "equal": True}
    out["sample_vs_off"] = {"dispatches": [d_smp, d_off],
                            "fenced": rep_smp.fenced_dispatches}
    del rec_off, rec_smp
    out["cli"] = profile_cli(data, dev)
    out["set_trace"] = profile_set_trace(data, dev)
    return out


def profile_cli(data, dev) -> dict:
    """`python -m systemml_tpu_torch -f LinearRegCG.dml ... -profile -trace
    out.json` on 200,000 rows of X (binary block), then `-trace
    out.jsonl`: the report is printed, out.json a Chrome trace with
    program_execute and dispatch events, out.jsonl one event a line."""
    import subprocess
    import tempfile

    from systemml_tpu_torch.io import matrixio
    from systemml_tpu_torch.runtime.data import MatrixObject

    d = tempfile.mkdtemp(prefix="smtorch-prof-")
    try:
        rows = 200_000
        matrixio.write_matrix(MatrixObject(data["X"][:rows].cpu()),
                              os.path.join(d, "X.bb"), "binary_block")
        matrixio.write_matrix(MatrixObject(data["y"][:rows].cpu()),
                              os.path.join(d, "y.csv"), "csv")
        res = {}
        for ext in ("json", "jsonl"):
            trace = os.path.join(d, f"out.{ext}")
            cmd = [sys.executable, "-m", "systemml_tpu_torch", "-f",
                   os.path.join(ALG, "LinearRegCG.dml"), "-nvargs",
                   f"X={d}/X.bb", f"Y={d}/y.csv", f"B={d}/B",
                   "fmt=binary", "maxi=20", "-profile", "-trace", trace]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True,
                               cwd=ROOT, timeout=600)
            secs = time.perf_counter() - t0
            if r.returncode != 0 or "Profile report (mode=full)" not in \
                    r.stdout:
                fail(f"[profile] CLI -profile -trace out.{ext}: rc "
                     f"{r.returncode}\n{r.stdout[-2000:]}\n"
                     f"{r.stderr[-2000:]}")
            if ext == "json":
                evs = json.load(open(trace))["traceEvents"]
            else:
                evs = [json.loads(ln) for ln in open(trace)]
            names = {e["name"] for e in evs}
            if not {"program_execute", "dispatch"} <= names:
                fail(f"[profile] CLI trace out.{ext} lacks program_execute "
                     f"or dispatch: {sorted(names)[:40]}")
            cov = [ln for ln in r.stdout.splitlines()
                   if ln.startswith("Profile report")][0]
            print(f"[profile] CLI -profile -trace out.{ext}: {len(evs)} "
                  f"events, {secs:.1f} s; {cov}", flush=True)
            res[ext] = {"events": len(evs), "seconds": secs, "report": cov}
        return res
    finally:
        shutil.rmtree(d, ignore_errors=True)


def profile_set_trace(data, dev) -> dict:
    """PreparedScript.set_trace on [serving]'s softmax scorer: a call
    writes its trace, keeps last_recorder and leaves no recorder
    installed."""
    import tempfile

    from systemml_tpu_torch import obs
    from systemml_tpu_torch.api.jmlc import Connection
    from systemml_tpu_torch.api.serving import ScoringService

    c = SERVING_CLASSES
    ps = Connection(config(3)).prepare_script(
        JMLC_SCRIPTS["softmax"][0], input_names=["X", "W", "b"],
        output_names=["yhat"],
        input_meta={"X": {"shape": (None, K)}, "W": {"shape": (K, c)},
                    "b": {"shape": (1, c)}})
    rng = np.random.default_rng(15)
    w = (rng.standard_normal((K, c)) / math.sqrt(K)).astype(np.float32)
    b = rng.standard_normal((1, c)).astype(np.float32)
    svc = ScoringService(ps, constants={"W": w, "b": b}, ladder=(64,),
                         validate="force")
    svc.warmup(K)
    d = tempfile.mkdtemp(prefix="smtorch-trace-")
    try:
        path = os.path.join(d, "score.json")
        ps.set_trace(path)
        x = data["X"][:40].cpu().numpy()
        got = svc.score(x)["yhat"]
        ps.set_trace(None)
        evs = json.load(open(path))["traceEvents"]
        z = x.astype(np.float64) @ w + b
        e = np.exp(z - z.max(axis=1, keepdims=True))
        ref = e / e.sum(axis=1, keepdims=True)
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else \
            np.asarray(got)
        err = float(np.abs(got - ref).max())
        names = {e["name"] for e in evs}
        ok = ("program_execute" in names and ps.last_recorder is not None
              and obs.active() is None and err <= 1e-5)
        print(f"[profile] PreparedScript.set_trace on the softmax scorer: "
              f"{len(evs)} events ({'dispatch' in names and 'dispatch'}), "
              f"last_recorder kept {ps.last_recorder is not None}, "
              f"obs.active() None {obs.active() is None}, answer within "
              f"{err:.2e} of torch's softmax", flush=True)
        if not ok:
            fail("[profile] PreparedScript.set_trace")
        return {"events": len(evs), "max_abs_err": err}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def profile_only() -> None:
    """K1's time and the [profile] phase alone, on the dense X: what
    `--profile` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.codegen import kernels

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    data = make_data(dev)
    x = data["X"]
    gen = torch.Generator(device=dev).manual_seed(3)
    v = torch.randn(K, 1, generator=gen, device=dev)
    k1_ms, = time_ms([lambda: kernels.mmchain_kernel(x, v)])
    mask = check_masked_product(dev, kernels)
    res = profile_phase(data, dev, kernels, smi, k1_ms)
    res["k1_ms"] = k1_ms
    res["mask"] = mask
    res["all_seconds"] = time.perf_counter() - t0
    print(json.dumps({"profile": res}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def slice14_only() -> None:
    """The kernel backend's, remote parfor's and the poisson draw's phases
    alone (`[poisson]`, `[backend]`, `[remote]`), with what they read:
    the main path's untuned run, LinearRegCG-cla's compressed X, the
    ratings V, and StepGLM's for run: what `--slice14` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    from systemml_tpu_torch.api.mlcontext import MLContext
    from systemml_tpu_torch.codegen import kernels

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    data = make_data(dev)
    poisson = check_poisson(dev)
    ml = MLContext()
    lines = []
    ml.printer = lambda s: None
    ml.execute(path_script("LinearRegCG", data, rows=8192))
    ml.printer = lines.append
    untuned = {}
    for run in ("first", "second"):
        with PhaseTimer() as timer:
            ml.execute(path_script("LinearRegCG", data)).get_tensor("beta")
            torch.cuda.synchronize()
        untuned[run] = phase_windows(
            timer, outer_iterations("LinearRegCG", lines),
            f"LinearRegCG untuned, {run} run")["iteration_ms"]
    census = make_census(dev)
    cla = {"LinearRegCG": {"auto": run_cla_path("LinearRegCG", "auto",
                                                census, dev, kernels)},
           "data": census}
    ratings = make_ratings(dev)
    t1 = time.perf_counter()
    backend = backend_phase(data, cla, ratings, dev, kernels, smi, untuned)
    backend_s = time.perf_counter() - t1
    del ratings, data
    torch.cuda.empty_cache()
    stepglm_data(census, dev)
    ref = run_stepglm(census, 3, "for", dev, kernels)
    census["stepglm_for"] = {"B": ref["out"], "selected": ref["selected"]}
    t1 = time.perf_counter()
    remote = remote_phase(census, dev, kernels, smi)
    remote_s = time.perf_counter() - t1
    print(f"[slice14] backend phase {backend_s:.1f} s, remote phase "
          f"{remote_s:.1f} s, all {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"poisson_draw": poisson, "backend": backend,
                      "remote_parfor": remote, "backend_s": backend_s,
                      "remote_s": remote_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def serving_only() -> None:
    """The serving phase alone (`[serving]`), on the dense X: what
    `--serving` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.codegen import kernels

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    data = make_data(dev)
    res = serving_phase(data, dev, kernels, smi)
    res["all_seconds"] = time.perf_counter() - t0
    print(json.dumps({"serving": res}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def breadth_only() -> None:
    """The algorithm-breadth paths and the datagen check alone (no kernel
    phase): what `--breadth` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    from systemml_tpu_torch.codegen import kernels

    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    data = make_data(dev)
    res = breadth_paths(data, dev, kernels)
    dg = check_breadth_datagen(dev)
    print(json.dumps({"breadth_paths": res, "breadth_datagen": dg,
                      "seconds": time.perf_counter() - t0}))


def parfor_only() -> None:
    """The parfor, Univar and transform phases alone, on the Census X, under
    the sync audit (no kernel phase): what `--parfor` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    from systemml_tpu_torch.codegen import kernels

    smi = nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    census = make_census(dev)
    audit = SyncAudit()
    res = {"parfor_stepglm": stepglm_phase(census, dev, kernels, smi),
           "parfor_univar": univar_phase(census, dev, kernels, smi),
           "transform": transform_phase(census, dev, smi)}
    res["region_syncs"] = audit.finish()
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res))


def dnn_only() -> None:
    """The normal draw and the DNN phases alone (no kernel phase): what
    `--dnn` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    from systemml_tpu_torch.codegen import kernels

    smi = nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    res = {"normal_draw": check_normal(dev),
           "conv_rule": conv_rule_phase(dev, smi),
           "resnet18": resnet18_phase(dev, kernels, smi, control=True),
           "lenet": lenet_phase(dev, kernels, smi)}
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res, default=str))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dnn"]:
        dnn_only()
    elif sys.argv[1:2] == ["--breadth"]:
        breadth_only()
    elif sys.argv[1:2] == ["--slice14"]:
        slice14_only()
    elif sys.argv[1:2] == ["--parfor"]:
        parfor_only()
    elif sys.argv[1:2] == ["--serving"]:
        serving_only()
    elif sys.argv[1:2] == ["--fleet"]:
        fleet_only()
    elif sys.argv[1:2] == ["--fleet-replica"]:
        fleet_replica(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--profile"]:
        profile_only()
    elif sys.argv[1:2] == ["--bench"]:
        bench(sys.argv[2] if len(sys.argv) > 2 else os.path.basename(ROOT))
    elif sys.argv[1:2] == ["--phases"]:
        phases()
    elif sys.argv[1:2] == ["--shapes"]:
        shapes_only()
    else:
        main()
