#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`infomax3d_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card (an H100)

Phases — each raises on failure, so any failure exits non-zero; each prints
its seconds:
1. device: a CUDA card must be present; prints `nvidia-smi`'s name and
   power limit.
2. build: compiles the kernels from `infomax3d_tpu_torch/csrc` (nvcc,
   sm_90a, one process per source in parallel) and prints the build time
   and ptxas's register report.
3. kernels: each forward kernel against its plain PyTorch version on the
   same CUDA tensors, at the bench shapes of the port's own batcher (500
   synthetic QM9-like molecules, seed 0: N = 9216, E = 18432, max_deg 4,
   D = 200); the stats kernel also at D = 50 and 300 (its element-wise and
   8-byte paths) and on a batch with nodes of degree 16; the edge
   combine at D = 200, 20 and 21 (16-byte, 8-byte and element-wise
   gathers) through its public wrapper, with 64-bit indices forced, on a
   run of E - 1 edges and on a pe shifted off 16-byte alignment, padding
   edges getting pe alone (`_hold_edge_combine`).  The two small
   CSR walks (the multi-reduce and the sender-keyed segment sum) bit for
   bit at D = 200, 300 and 302, and on batches with in- and out-degree 16
   at D = 200 and 50, the multi-reduce also cut at K = 3, each through
   its public wrapper and with 64-bit indices forced, padding edges
   ignored (`_hold_walks`).
4. serving: `inference()` serves 2 requests of 500 molecules through the
   PNA 200x7 model of `configs_clean/pre-train_QM9.yml` (seeded numpy
   weights in the JAX layout, through `params_from_jax`) in bf16 (asked
   for explicitly) and in float32; each fingerprint matrix is held
   against the same model and batch on the CPU (which runs the plain
   versions), and each forward's kernel launches are counted.  Then ms per forward and graphs/s.
5. profile: torch.profiler's kernel records of warm forwards — device-busy
   time per forward, its idle share and the top kernels.
6. kernel times: device times (CUDA events, the host's launches kept out
   of them) of each forward kernel — cold-L2 and warm — and of its plain
   version at the bench shapes, beside the least time the card could take
   (bytes over the H100's memory rate, operations over its float32 rate).
7. training kernels: the pair segment sum (bf16, float32; the widths
   and paths of phase 3's edge combine, padding edges ignored,
   `_hold_pair_segment_sum`) and the stats backward (with and without the affine, with every cotangent or some
   missing, on phase 3's cases) against their plain versions; the stats
   backward also on two streams at once, each stream with its own chunk
   counters.
8. training: the pre-training step of `configs_clean/pre-train_QM9.yml`
   (PNA 200x7 + Net3DDense hidden 20, NT-Xent tau 0.1, Adam lr 8e-5) on the
   port's bench batch through `pretrain()`: launches per step, loss over
   the steps; one float32 and one bf16 step on the card against the CPU's
   float32 step (loss, every gradient, running statistics; bf16 within
   twice the CPU's own bf16 step's distance), and two planted faults in
   the stats backward (zeroed affine cotangents; the d_max / d_min routing
   dropped) that must each fail the bf16 check; ms per
   step, graphs/s and edges/s.
9. training profile: torch.profiler over warm bf16 steps, the port's
   kernels split by `__global__`.
10. training kernel times: the two backward kernels as in phase 6, with
   the nearest PyTorch call where there is one.
11. GIN kernels: the CSR sum and the sender-keyed segment sum (bf16,
   float32) against their plain versions at the GIN slice's batch (128
   synthetic molhiv-like molecules, seed 0: N = 3328, E = 7168, D = 300),
   and at D = 302, a width that takes the other vector paths, the CSR sum
   also with 64-bit indices forced and on messages shifted off 16-byte
   alignment (`_hold_csr_sum`); the multi-reduce on the same batch
   (`_hold_walks`).
12. GIN training: the supervised step of `configs/30.yml` (OGBGNN, GIN
   5x300 without a virtual node, sum pooling, BCEWithLogitsLoss, Adam lr
   1e-3, batch 128) through `supervised()`, 20 steps in bf16 and in
   float32: launches per step, loss over the steps; one step on the card
   against the same step on the CPU; ms per step and graphs/s.
13. GIN profile and kernel times: torch.profiler over warm steps, then the
   two GIN kernels as in phase 10.
14. OT kernels: the CSR segment sum (bf16, float32) bit for bit against
   its plain version at the OT slice's batch (16 synthetic QM9-like
   molecules with 10 conformers, seed 0) at D = 50, 300 and 302, at the
   bench shapes (D = 200) and on a batch with in-degree-16 nodes, which
   together take every vector path; the OT step's other two kernels, the
   multi-reduce and the sender-keyed segment sum, on the OT batch at
   D = 50, 300 and 302; each through its public wrapper and with 64-bit
   indices forced, padding edges ignored (`_hold_walks`).
15. OT training: the optimal-transport step of
   `configs_clean/pre-train_Optimal_Transport_baseline.yml`
   (OptimalTransportModel over PNAGNNRandomEdgeUpdate 50x3, 10 model and
   10 true conformers, exact EMD, Adam lr 1e-3, clip 10, batch 16) through
   `ot()`, 10 float32 steps: launches per step, loss over the steps; one
   step on the card against the same step on the CPU with the same draws
   and plans (cost, loss, every gradient leaf), and two planted faults (a
   zeroed receiver-gather backward; the torsion head's gradient alone
   scaled) that must each fail that check; ms per step split into cost
   pass, host EMD and gradient pass plus update; graphs/s; the step with
   its noise drawn on the card against the same step drawing on the host.
16. OT profile and kernel times: torch.profiler over warm steps, then the
   CSR segment sum as in phase 13 (and against `index_add_` in 6
   interleaved repeats, cold and warm) and the multi-reduce and the
   sender-keyed segment sum at the OT shape; then the ladder of the OT
   step's small CSR walks (the empty kernel, the index round trip, each walk alone and in
   the step, on the walks' grid) beside the byte bounds of rows 1, 3 and 4
   at the OT shapes, and each row's closable gap.
17. trainer CLI: `load_config` + `train` of `configs_clean/pre-train_QM9.yml`
   (bf16, 2 epochs of 2 steps on 5000 synthetic molecules) and then of
   `configs_clean/tune_QM9_homo.yml` (bf16, 2 epochs of 8 steps,
   transferring from the pre-training's best checkpoint), with launches
   per run from the steps and eval forwards, the transfer count from the
   module, the best checkpoint reloaded bit for bit (in the run and in a
   new trainer) with a planted fault that must fail (a checkpoint without
   running statistics), and a float32 1-epoch pre-training held to the
   same run on the CPU; per run the ms per epoch, steps/s, the step inside
   the loop against the bare step and the host seconds in the loader,
   metrics, checkpoints and logging.
18. multi-conformer pre-training: the architecture of
   `configs_clean/pre-train_QMugs.yml` (C = 3) and
   `configs_clean/pre-train_GEOM-Drugs.yml` (C = 5): phase 8's PNA 200x7
   with the flat Net3D (hidden 20, 1 layer, mean) on the CSR batch of each
   molecule's C conformer complete graphs, NTXentMultiplePositives tau
   0.1, Adam lr 8e-5, batch 500 synthetic molecules of 20 to 70 atoms.
   (a) rows 5, 6 and 7 at both conformer batches (in-degree up to 69)
   at D = 20 and 21 in bf16 and float32, bit for bit against their plain
   versions with padding edges ignored, on every path their launchers
   pick (as in phases 3 and 7; row 7 through its stream there and through
   its walk at the drug-size 2D batch, `_hold_csr_sum`), each with the
   path it takes; the 2D side's kernels at the drug-size 2D batch; (b) 20
   bf16 and 20 float32 QMugs steps and 10 of each GEOM-Drugs step through
   `pretrain()` (launches per step, loss over the steps); one bf16 and one
   float32 QMugs step on the card against the CPU under phase 8's bounds,
   with two planted faults that must each fail (the conformers packed
   graph-major; the `csr_mean` gradient dropped); per configuration ms per
   step, graphs/s, edges/s (2D + 3D), peak `max_memory_allocated`, the
   profile (busy and idle share, kernels per step) and rows 5, 6 and 7's
   times at the conformer shape beside their bounds and `index_add_`
   (row 7 in bf16 and float32; row 5 also beside its bytes with ct read
   twice, and each of its halves alone);
   (c) `load_config` + `train` of `pre-train_QMugs.yml` in bf16, 1 epoch
   of 2 steps on 5000 synthetic drug-size molecules, launches from the
   steps and eval forwards.
19. data layer: the port's `preprocess_qm9` on `tests/fixtures/qm9_slice`
   (the facts `tests/test_real_qm9_slice.py` holds; a planted fault, the
   csv's columns left in raw order, must fail them), then
   `tune_QM9_homo.yml` fine-tuned on the card from that cache (float32,
   batch 4, 2 steps; the denormalised MAE in the JAX test's range); the
   molecules of phases 17 and 18 written as `QM9` and `QMugs` caches
   (`write_synthetic_cache`; QM9's items equal `SyntheticDataset`'s) and
   a molhiv-shaped cache of 4096 molecules with one binary target and no
   stored split (the port's Murcko / WL scaffold split); through the CLI
   from those caches: phase 17's float32 1-epoch pre-training (held to
   phase 17's float32 card run under `F32_RUN_TOL`) and its bf16 one,
   phase 18's QMugs run and `configs/30.yml` (GIN 5x300, bf16, 1 epoch
   over the scaffold train set, ogbg-molhiv's ROC-AUC as the main
   metric), launches per step as in phases 17, 18 and 12; each cache's
   write and load seconds, the scaffold split's, and each run's host
   seconds waiting on the loader per train step beside its
   synthetic-served run.
20. serving CLI: 5000 drug-like SMILES (20 to 70 heavy atoms) from a
   seeded fragment grammar (`drug_smiles`) served through
   `cli.inference.main` with a YAML config (`yaml_lite`) from phase 18c's
   QMugs checkpoint (PNA 200x7, target 256, batch 500, float32); the JAX
   fixture's SMILES (`tests/fixtures/jax_serving`) from its flax msgpack
   checkpoint against the JAX CLI's stored fingerprints; one fine-tune
   step transferring from that checkpoint (the JAX CLI's count);
   `configs/30.yml`'s GIN from phase 19's checkpoint over its molhiv
   cache; `cli.analysis.main` on the 5000; launches per request; the
   first 500 SMILES and the GIN request on the CPU against the card, with
   a planted fault (the request served in bf16) that must fail; host
   seconds to read and featurize and to collate, device ms per batch,
   molecules/s end to end.
21. pre-training baselines: (a) `configs_clean/pre-train_distance_predictor_
   baseline.yml` (DistancePredictor over PNA 200x7 with one transformer
   layer and the symmetrised distance net, L1 over the pairs, Adam 1e-3,
   batch 100), (b) `configs/contrastive_training_Net3DAE.yml` (PNA 200x7
   against Net3DAE hidden 70, NTXentAE, batch 50) and (c) `configs_clean/
   pre-train_graphCL_baseline.yml` (PNA 200x7 on two node-dropped views,
   NT-Xent, batch 500), at the configs' widths from seeded weights: one
   float32 step on the card against the CPU (loss, gradients, running
   statistics, the weights after one Adam step; QM9-size molecules for (a)
   and (b), 100 drug-size molecules for (c)) with a planted fault each
   that must fail it (the distance net's second half dropped; the
   reconstruction zeroed; view1 read twice); the launches per bf16 step
   split into the 2D side, the 3D side and the pair view (width 1); rows
   6 and 5 at D = 1 on the pair views bit for bit against their plain
   versions and timed cold and warm beside their byte bounds; ms per bf16
   step, graphs/s and peak memory at the configs' batches; each config
   through the CLI in bf16 (1 epoch of 3 steps on phase 19's QM9 and QMugs
   caches: the main path), then `tune_QM9_homo.yml` one step from (a)'s
   checkpoint with the JAX CLI's transfer count.
22. the OT family through its trainer, float32, at the configs' widths:
   (a) `configs_clean/pre-train_Optimal_Transport_baseline.yml`
   (PNAGNNRandomEdgeUpdate 50x3), (b) `configs/ot_gin.yml` (the
   virtual-node GIN 5x300 with dropout 0.5 under the model's 50), (c)
   `configs/ot_geomol_gnn.yml` (GeomolGNNOGBFeat 100x5, two GNNs), each
   with 10 model and 10 true conformers: one trainer step on the card
   against the CPU from the same weights, batch (16 QM9-size molecules
   for (a) and (b), drug-size for (c)), draws and dropout masks (cost,
   loss, every gradient leaf against a witness, running statistics,
   Adam's update), (a) with `ignore_neighbors` off and on, and a planted
   fault each that must fail (the dihedral terms kept with
   `ignore_neighbors`; the cost pass in training mode; gnn2 reading gnn's
   weights); rows 7 and 4 bit for bit at (b)'s batch at D = 300 and row
   1 at (a)'s; launches per step, exact; ms per step, graphs/s, the host
   EMD, peak memory and kernels per step; rows 7 and 4 at (b)'s shape
   cold and warm beside their byte bounds; then (a), (b), (c) through
   the CLI on synthetic caches (2 epochs of 3 steps, (a)'s first
   local-only, the learning rate of each step printed), launches per run,
   and (d) `configs/tune_from_ot_pna.yml` from an OT checkpoint of
   `configs/ot_pyg_in_memory.yml`'s model (GeomolGNNOGBFeat 50x3) with the
   JAX CLI's transfer count, on an ogbg-molesol-shaped cache.
23. the GIN's options and the transformers through the supervised trainer,
   at the configs' widths: (a) `configs/gin_ogb_2.yml` (OGBGNN GIN 5x300,
   dropout 0.5), (b) `configs/gin_random.yml` (OGBGNNRandom 5x300,
   virtual node, dropout 0.5), (c) `configs/pnatransformer.yml`
   (PNATransformer 200x7, 10 heads), (d) `configs/pnatransformer_ogbg.yml`
   (512x6, 32 heads, dropout 0.1), (e) `configs/transformer.yml`
   (TransformerPlain 512x6, Laplacian PE, the dense batch), (f)
   `configs/transformer_ogbg.yml`, and (a)'s model with GCN convolutions
   and attention pooling: rows 7 and 4 bit for bit at (a)'s batch (32
   molecules, D = 300) and rows 6, 2, 8, 5 and 1 at (c)'s (128, D = 200);
   one float32 and one bf16 step of (b), (c), (d), (e) and the GCN path
   on the card against the CPU's float32 step (31 graphs, the dropout
   masks drawn once and replayed on both sides, phase 8's bounds), with
   planted faults that must each fail the bf16 check (the virtual node's
   pooled message dropped; the masks without their 1 / keep_prob scale;
   `dense_to_flat` reading the next slot; the attention key mask ignored;
   the PNA layers' masks drawn and not applied; the Laplacian PE's
   (eigenvalue, entry) pairs swapped; the GCN edge normalisation from the
   sender's degree alone);
   launches per bf16 step, exact; ms per step, graphs/s, peak memory,
   kernels per step and the idle share at each config's batch; rows 7 and
   4 at (a)'s shape cold and warm beside their byte bounds; (a) to (f)
   through the CLI (1 epoch on synthetic caches of their datasets, dropout
   masks drawn on the card, (b)'s noise columns zero) with their launches,
   and `configs/pnatransformersimple_ogbg.yml` refused (width 80, 32
   heads).
24. PNAOriginal and SMP through the supervised and contrastive trainers,
   at the configs' widths and batches: (a) `configs/pna_original.yml`
   (PNAOriginal 90x4, 5 towers, graph norm, batch 128, QM9-size), (b)
   `pna_original_molhiv.yml` (70x4, molhiv-size), (c)
   `pna_original_simple.yml` (PNAOriginalSimple 70x4, dropout 0.3,
   residual), (d) `contrastive_training_pna_original.yml` (PNAOriginal
   70x4 beside the flat Net3D, NT-Xent, batch 500 drug-size), (e)
   `SMP_geomol_conformers.yml` (SMP 128x4, cutoff 5, batch 32): every
   kernel bit for bit at its new call sites (rows 6, 5, 2, 8 and 1 at the
   towers' widths 90 / 18 and 70 / 14, row 4 at (c)'s batch, and at (e)'s
   row 7 over the receivers and over the triplets, row 4 keyed by
   `idx_kj` and by the senders, row 3); one float32 and one bf16 step of
   each on the card against the CPU's float32 step (31 graphs, (c)'s
   masks replayed), with planted faults that must each fail the bf16
   check (graph norm by the batch's node count; the attenuation scaler
   computed as the amplification; the masks without their 1 / keep_prob
   scale; the triplet message gathered at the edge j -> i; the triplet
   gather's backward without its CSC order); launches per bf16 step,
   exact; ms per step, graphs/s, peak memory, kernels per step and the
   idle share; rows 2 and 8 in (a)'s step and row 7 over (e)'s triplets
   beside their bounds; the host ms of `smp_collate` per batch; (a) and
   (e) through the CLI (1 epoch on a synthetic QM9 cache) with their
   launches, and the slice's other configs (`pna_original_simple_molhiv`,
   `SMP_rdkit_conformers`, `sphere_net`) resolved and built.
25. BYOL, EGNN and SAN through the trainers, at the configs' widths and
   batches, bf16: (a) `configs/byol.yml` (BYOL wrappers around PNA 90x6
   and the flat Net3D 20x1, predictors 256, batch 250 QM9-size), (b)
   `configs/0.yml` (PNA 90x6 beside EGNN 128x7, NT-Xent, batch 500),
   (c) `configs/san.yml` and (d) `san_ogbg.yml` (SAN 64 x 10 layers, LPE
   16 x 3, batches 4 and 64), (e) EGNNTorch at `egnn_dense`'s defaults on
   `egnn_padded_collate` (128 wide, batch 128): rows 6, 5, 2, 8 and 1 bit
   for bit on (a)'s bond graphs, rows 6, 5 and 7 on (a)'s and (b)'s
   complete graphs (D = 20 and 128); one float32 and one bf16 step of
   each on the card against the CPU's float32 step (the CPU's own bf16
   distance the largest of three readings), with planted faults that
   must each fail (the teachers in eval mode; each prediction against its
   own side's projection; the squared distance from the receiver alone;
   the gate dropped; SAN's channels' masks swapped; its score clamp
   dropped); (a)'s state after a step (the 2D teacher moved by exactly
   the EMA, the 3D teacher's weights unchanged, both teachers' running
   statistics moved; the EMA on both teachers must fail it) and the
   teachers' forwards through the kernels against the plain versions bit
   for bit; launches per bf16 step, exact; ms per step, graphs/s, peak
   memory, kernels per step and the idle share; (a), (b), (c) through
   the CLI (1 epoch on a synthetic QM9 cache) with their launches, and
   (d) resolved and built.
26. The last trainers and model names at configs_clean/pre-train_QM9.yml's
   architecture (PNA 200x7, the flat Net3D 20x1, batch 500), bf16: the
   philosophy step (Critic 256 x 2 layers x 4 repeats, CriticLoss), an
   even and an odd alternating step, the noisy-negatives step
   (`noised_distances_collate`, NTXentExtraNegatives), and supervised L1
   steps of PNARandom, PNARandomEdgeUpdate and PNA with
   `pairwise_distances`: rows 6 and 5 (bf16 and float32), 2, 8, 1, 4 and 3
   bit for bit on the bond graphs (D = 200), rows 6, 5 and 7 on the
   complete graphs (D = 20); one float32 and one bf16 step of each on the
   card against the CPU's float32 step (the models each step trains),
   with planted faults that must each fail (the philosopher's sign; the
   odd step run as an even one; the extra negatives dropped; the distance
   column dropped); launches per bf16 step, exact; ms per step, graphs/s,
   peak memory, kernels per step and the idle share; the philosophy
   trainer through the CLI (1 epoch on a synthetic QM9 cache, the critic
   and the three optimizers in its checkpoint) with its launches, and
   `configs/tune_from_ot_geomoL_feat.yml` through the CLI on a synthetic
   `qm9_geomol` cache of float features, from scratch and again from the
   first run's checkpoint (its transfer moves nothing, as the JAX CLI's).
27. Data parallelism (`n_shards: 2`, `infomax3d_tpu_torch/parallel/`),
   the kernels built once (phase 2) before any rank starts: (a) the bf16
   pre-training step of `configs_clean/pre-train_QM9.yml` (PNA 200x7 +
   Net3DDense, batch 500) through a one-rank NCCL group, bit for bit the
   step without a group; (b) two ranks on the one card over gloo (named:
   NCCL refuses two ranks on one card), each on its half of the batch
   (250 molecules; `configs/30.yml`'s GIN step, 64 of 128), float32 and
   bf16, against one process on the whole batch on the card: float32
   within phase 8's STEP_TOL, bf16 within `_bf16_limits` of two rounding
   witnesses of the one-process bf16 step (its weights scaled by 1 + j *
   2^-16 U(-1, 1)); the ranks bit-equal, launches per rank and step
   exact; the all-reduce and all-gather calls of a step with their host
   ms, and ms per step of the two ranks time-sliced on one card (not a
   measure of data-parallel speed); (c) the training CLI on
   `pre-train_QM9.yml` with `n_shards: 2` as torchrun starts it (1 epoch
   of 2 steps on 5000 synthetic molecules): one run directory, the ranks'
   results equal, launches exact; (d) three planted faults (BatchNorm
   statistics left local; the contrastive loss on the local rows; the
   gradients summed, not averaged) that must each fail (b)'s float32
   check.
28. `remat`, the non-CSR batch and the partitioned modes: (a) phase 18's
   QMugs bf16 step (batch 500, C = 3) with and without `remat`: loss,
   gradients and running statistics bit for bit where the step repeats
   itself bit for bit, else within `_bf16_limits` of its own run-to-run
   reading; launches per step of rows 6, 2, 5, 8 and 7 with remat (each
   forward kernel twice: the recompute), peak `max_memory_allocated`
   and ms per step of both; (b) `pre-train_QM9.yml`'s PNA 200x7 with the
   flat Net3D (batch 500) on the non-CSR batch (the segment path, no
   kernel) against the same step on the CSR batch: float32 within phase
   8's STEP_TOL, bf16 against the CSR float32 step within `_bf16_limits`
   of the CSR bf16 step's own distance from it (the witness); ms per bf16
   step of both; (c) `graph_shards: 2` and
   `node_shards: 2` of (b)'s float32 and bf16 steps over two gloo ranks
   on the one card against (b)'s one process on the whole non-CSR batch
   (float32 within STEP_TOL, the running statistics within the JAX
   package's own edge-mode bound, 1.2e-2, and the CPU test's node-mode
   bound, 2e-3: rows whole on every rank count twice in the unbiased
   correction, as in JAX; bf16 against the float32 one process within
   `_bf16_limits` of three witnesses: the one-process bf16 step's own
   distance from it at the seeded weights and at weights scaled by 1 +
   j * 2^-16 U(-1, 1), j = 1, 2), the ranks
   bit-equal, three planted
   faults that must each fail (an edge shard's aggregation not
   completed; the halo exchange's backward dropping the ghost
   cotangents; the BatchNorm statistics not completed over the graph
   group; the halo fault is read on a graph spanning the shards, N =
   4096, whose halo check in float64 it must fail); the collectives of a
   step (calls, elements, host ms), the halo rows per round, and ms per
   bf16 step of the two ranks time-sliced on one card (not a measure of
   speed).
29. Tensor parallelism and the native host collate: four gloo ranks on
   the one card form a 2 x 2 (data, model) grid; (a) ranks 0 and 1 run
   phase 27's pre-training step (float32, bf16) and GIN step (float32)
   with `model_shards: 2` on the whole batch against phase 27's one
   process (float32 within STEP_TOL, bf16 within its `_bf16_limits`),
   launches per rank those of one process, the model ranks bit-equal
   after three steps, the bytes of masters and Adam moments per rank,
   the shard gathers of a step with their host ms, ms per bf16 step
   (not a measure of speed); (b) every rank runs the pre-training step
   of `n_shards: 2` x `model_shards: 2` against phase 27's data-parallel
   ranks; (c) ranks 0 and 1 run the CLI with `model_shards: 2`, whose
   checkpoint loads strictly into the one-process models; (d) three
   planted faults (the gather's backward summed over the model ranks,
   the shards gathered in reversed rank order, the gradient mean over
   the model ranks) that must each fail (a)'s float32 check.  Meanwhile
   the host collates phase 18's QMugs batch natively and with numpy:
   every array equal, host ms of each.
It prints a `{"kernels": [...]}` line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from infomax3d_tpu_torch.cli.inference import build_model, inference
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.interop import init_jax_variables
from infomax3d_tpu_torch.models.noise import (GeneratorNoise, MasksOnly,
                                              ReplayNoise)
from infomax3d_tpu_torch.ops.kernels import (WRAPPERS, csr_segment_sum,
                                             csr_segment_sum_reference,
                                             csr_sum,
                                             csr_sum_reference, edge_combine,
                                             edge_combine_reference,
                                             multi_reduce,
                                             multi_reduce_reference,
                                             pair_segment_sum,
                                             pair_segment_sum_reference,
                                             pna_stats, pna_stats_bwd,
                                             pna_stats_bwd_reference,
                                             pna_stats_reference,
                                             snd_segment_sum,
                                             snd_segment_sum_reference)
from infomax3d_tpu_torch.ops.kernels._build import build_all, launcher
from infomax3d_tpu_torch.ops.kernels.pna_stats_bwd import COTANGENTS
from infomax3d_tpu_torch.train.pretrain import (build_step,
                                                conformer_batches,
                                                flagship_batches, pretrain)
from infomax3d_tpu_torch.train.ot import OTStep, build_ot_step, ot, ot_batch
from infomax3d_tpu_torch.train.supervised import (build_supervised_step,
                                                  labelled_batch,
                                                  masks_source, supervised)

# configs_clean/pre-train_QM9.yml `model_parameters` (no YAML on the card)
MODEL_PARAMETERS = {
    "target_dim": 256,
    "hidden_dim": 200,
    "mid_batch_norm": True,
    "last_batch_norm": True,
    "readout_batchnorm": True,
    "batch_norm_momentum": 0.93,
    "readout_hidden_dim": 200,
    "readout_layers": 2,
    "dropout": 0.0,
    "propagation_depth": 7,
    "aggregators": ["mean", "max", "min", "std"],
    "scalers": ["identity", "amplification", "attenuation"],
    "readout_aggregators": ["min", "max", "mean"],
    "pretrans_layers": 2,
    "posttrans_layers": 1,
    "residual": True,
}
# ... and its `model3d_parameters`, `loss_params` and `optimizer_params`
MODEL3D_PARAMETERS = {
    "target_dim": 256,
    "hidden_dim": 20,
    "hidden_edge_dim": 20,
    "node_wise_output_layers": 0,
    "message_net_layers": 1,
    "update_net_layers": 1,
    "reduce_func": "mean",
    "fourier_encodings": 4,
    "propagation_depth": 1,
    "dropout": 0.0,
    "batch_norm": True,
    "readout_batchnorm": True,
    "batch_norm_momentum": 0.93,
    "readout_hidden_dim": 20,
    "readout_layers": 1,
    "readout_aggregators": ["min", "max", "mean"],
}
LOSS_PARAMS = {"tau": 0.1}
OPTIMIZER_PARAMS = {"lr": 8.0e-5}
BATCH = 500
DATA = {"num": BATCH, "n_min": 10, "n_max": 26}
TRAIN_STEPS = 20
WIDTH = MODEL_PARAMETERS["hidden_dim"]
DEPTH = MODEL_PARAMETERS["propagation_depth"]

# configs/30.yml `model_type`, `model_parameters`, `loss_func`,
# `optimizer_params` and `batch_size` (no YAML on the card).  `emb_dim` is
# no field of OGBGNN and is dropped, as the JAX package drops it; the width
# is the model's default `hidden_dim`, 300.
GIN_MODEL_TYPE = "OGBGNN"
GIN_MODEL_PARAMETERS = {
    "target_dim": 1,
    "num_layers": 5,
    "dropout": 0.0,
    "batch_norm_momentum": 0.1,
    "emb_dim": 300,
    "virtual_node": False,
}
GIN_LOSS = "BCEWithLogitsLoss"
GIN_OPTIMIZER_PARAMS = {"lr": 1.0e-3}
GIN_BATCH = 128
# synthetic molhiv-like molecules: 10 to 41 atoms, 25.5 on average
GIN_DATA = {"seed": 0, "n_min": 10, "n_max": 41}
GIN_WIDTH = 300
GIN_DEPTH = GIN_MODEL_PARAMETERS["num_layers"]

# configs_clean/pre-train_Optimal_Transport_baseline.yml `model_parameters`,
# `optimizer_params` and `batch_size`.  The dataset (GEOM-QM9 pickles) is
# not in the repo: synthetic QM9-like molecules with 10 conformers each
# stand in; the WarmUpWrapper schedule belongs to the trainer (phase 22),
# so phase 15's bare step takes the config's lr.
OT_MODEL_PARAMETERS = {
    "gnn_model": "PNAGNNRandomEdgeUpdate",
    "gnn_params": {
        "hidden_dim": 50,
        "mid_batch_norm": False,
        "last_batch_norm": False,
        "readout_batchnorm": True,
        "batch_norm_momentum": 0.1,
        "dropout": 0.0,
        "propagation_depth": 3,
        "aggregators": ["sum"],
        "scalers": ["identity"],
        "pretrans_layers": 2,
        "posttrans_layers": 2,
        "residual": False,
    },
    "hyperparams": {
        "alpha_mlp": {"n_layers": 2},
        "c_mlp": {"n_layers": 1},
        "coord_pred": {"n_layers": 2},
        "d_mlp": {"n_layers": 1},
        "encoder": {"n_head": 2},
        "global_transformer": False,
        "h_mol_mlp": {"n_layers": 1},
        "loss_type": "ot_emd",
        "hidden_dim": 50,
        "n_model_confs": 10,
        "n_true_confs": 10,
        "random_alpha": False,
        "random_vec_dim": 10,
        "random_vec_std": 1.0,
        "teacher_force": False,
    },
}
OT_OPTIMIZER_PARAMS = {"lr": 1.0e-3}
OT_BATCH = 16
OT_DATA = {"seed": 0, "n_min": 10, "n_max": 26}
OT_WIDTH = OT_MODEL_PARAMETERS["gnn_params"]["hidden_dim"]
OT_DEPTH = OT_MODEL_PARAMETERS["gnn_params"]["propagation_depth"]
OT_CONFS = OT_MODEL_PARAMETERS["hyperparams"]["n_model_confs"]

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# float32 outside the tensor cores (the kernels' arithmetic is float32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Tolerances of the kernels against their plain versions on the card:
# edge_combine: both sum the same three float32 terms in the same order and
#   round once -> bit-exact.
# pna_stats: the same float32 statistics in the same slot order with the
#   same rounding points, each rounded once -> bit-exact in every section.
# multi_reduce, snd_segment_sum: the same float32 sums in the same slot
#   order, max / min exact -> bit-exact in every section (`_hold_walks`).
# Fingerprints on the card against the same model and batch on the CPU,
# relative to max|cpu|: float32 matmuls in full float32 on both (TF32 off,
# set below), so only summation order differs -> 1e-4; bf16 matmuls
# accumulate in another order and round at bf16 on both sides, through 7
# layers -> 3e-2.
SLICE_TOL = {True: 3e-2, False: 1e-4}
# the widths at which phases 3, 7 and 18a hold rows 6 and 5 on the bench
# and drug-size 2D batches: the PNA's (16-byte rows in bf16 and float32),
# the Net3D's (40-byte bf16 rows: 8-byte pieces; 80-byte float32 rows) and
# one more (42- and 84-byte rows: element-wise gathers)
COMBINE_WIDTHS = (WIDTH, MODEL3D_PARAMETERS["hidden_dim"],
                  MODEL3D_PARAMETERS["hidden_dim"] + 1)
# launches per forward, from the model's depth
NONE = {"edge_combine": 0, "pna_stats": 0, "multi_reduce": 0,
        "pair_segment_sum": 0, "pna_stats_bwd": 0, "csr_sum": 0,
        "snd_segment_sum": 0, "csr_segment_sum": 0}
EXPECTED = {True: dict(NONE, edge_combine=DEPTH, pna_stats=DEPTH),
            False: dict(NONE, edge_combine=DEPTH, multi_reduce=DEPTH)}
# launches per training step: each PNA layer runs the combine and its
# backward, and the bf16 stats and their backward or the float32
# multi-reduce (whose backward is plain PyTorch)
EXPECTED_STEP = {True: dict(NONE, edge_combine=DEPTH, pna_stats=DEPTH,
                            pair_segment_sum=DEPTH, pna_stats_bwd=DEPTH),
                 False: dict(NONE, edge_combine=DEPTH, multi_reduce=DEPTH,
                             pair_segment_sum=DEPTH)}
# launches per GIN step, in bf16 and float32 alike: each layer sums its
# messages (forward) and sums the gathered rows' cotangents by sender (the
# gather's backward; the atom encoder needs layer 0's too)
EXPECTED_GIN_STEP = dict(NONE, csr_sum=GIN_DEPTH, snd_segment_sum=GIN_DEPTH)
# launches per OT step: 2 backbones x 10 conformers x 3 layers run in the
# cost pass (the float32 aggregate, multi_reduce) and again in the gradient
# pass, whose backward sums each layer's sender and receiver gathers
OT_PASS = 2 * OT_CONFS * OT_DEPTH
EXPECTED_OT_STEP = dict(NONE, multi_reduce=2 * OT_PASS,
                        snd_segment_sum=OT_PASS, csr_segment_sum=OT_PASS)

def _expect(step: dict, fwd: dict, steps: int, evals: int) -> dict:
    """A run's launches: `steps` training steps and `evals` forwards."""
    return {n: step[n] * steps + fwd[n] * evals for n in NONE}


KERNEL_INFO = {
    "edge_combine": ("infomax3d_tpu_torch/csrc/edge_combine.cu",
                     "infomax3d_tpu/ops/pallas/spmm.py:1123"),
    "pna_stats": ("infomax3d_tpu_torch/csrc/pna_stats.cu",
                  "infomax3d_tpu/ops/pallas/spmm.py:458"),
    "multi_reduce": ("infomax3d_tpu_torch/csrc/multi_reduce.cu",
                     "infomax3d_tpu/ops/pallas/spmm.py:64"),
    "pair_segment_sum": ("infomax3d_tpu_torch/csrc/pair_segment_sum.cu",
                         "infomax3d_tpu/ops/pallas/spmm.py:1006"),
    "pna_stats_bwd": ("infomax3d_tpu_torch/csrc/pna_stats_bwd.cu",
                      "infomax3d_tpu/ops/pallas/spmm.py:1408"),
    "csr_sum": ("infomax3d_tpu_torch/csrc/csr_sum.cu",
                "infomax3d_tpu/ops/pallas/spmm.py:1310"),
    "snd_segment_sum": ("infomax3d_tpu_torch/csrc/snd_segment_sum.cu",
                        "infomax3d_tpu/ops/pallas/spmm.py:1001"),
    "csr_segment_sum": ("infomax3d_tpu_torch/csrc/csr_sum.cu",
                        "infomax3d_tpu/ops/pallas/spmm.py:837"),
}
# No single PyTorch call computes the three forward functions: the combine
# is two row gathers plus adds, the stats and the multi-reduce are 4-6
# reductions per call (torch.segment_reduce does one at a time).
LIBRARY_MS = None


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def phase_device() -> str:
    _check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return smi


def phase_build():
    t0 = time.perf_counter()
    logs = build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'already built'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def bench_batch():
    ds = SyntheticMolecules(seed=0, **DATA)
    graphs = [ds.graph2d(i) for i in range(BATCH)]
    b = bucket_for(graphs, BATCH)
    return to_graph_batch(batch_graphs(graphs, b), b, "cuda")


def _max_err(pairs) -> float:
    return max(float((k.float() - r.float()).abs().max()) for k, r in pairs)


def degree16_csr(N: int = 4096, seed: int = 0):
    """A receiver-sorted CSR batch on the card with in-degrees 0 to 4 and
    every 61st node of degree 16, the most the stats kernels take (K =
    16), then 24 padding edges: (row_ptr, edges with padding)."""
    deg = np.random.default_rng(seed).integers(0, 5, N)
    deg[::61] = 16
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return torch.from_numpy(rp).cuda(), int(rp[-1]) + 24


def degree16_csc(N: int = 4096, seed: int = 1):
    """A sender-sorted CSC on the card with out-degrees 0 to 4 and every
    61st node of degree 16, its positions a random permutation of the real
    edges, then 24 padding edges: (csc_row_ptr, csc_perm, edges with
    padding)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 5, N)
    deg[::61] = 16
    crp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e_real = int(crp[-1])
    perm = np.concatenate([rng.permutation(e_real),
                           np.arange(e_real, e_real + 24)]).astype(np.int32)
    return (torch.from_numpy(crp).cuda(), torch.from_numpy(perm).cuda(),
            e_real + 24)


def _hold_walks(phase: str, gen, recv_cases, send_cases,
                seg_cases=()) -> dict:
    """Rows 1 (`multi_reduce`), 4 (`snd_segment_sum`) and 3
    (`csr_segment_sum`) against their plain versions on the same CUDA
    tensors, in float32 and bf16 at each case's widths: the public wrapper
    (the main paths' call, 32-bit indices at these shapes), then the raw
    launch with 64-bit indices forced; both sum the same rows in float32 in
    slot order (and the segment sums round once), max / min select ->
    bit-exact.  Nodes without edges get 0; rows past the ranges (padding
    edges, and for row 1 the slots past K) never count.  recv_cases:
    (name, row_ptr, K, edges, widths); send_cases: (name, csc_row_ptr,
    csc_perm, edges, widths); seg_cases: (name, row_ptr, edges, widths).
    Returns the max |kernel - plain| of each."""
    public = {"multi_reduce": multi_reduce, "snd_segment_sum": snd_segment_sum,
              "csr_segment_sum": csr_segment_sum}
    plain = {"multi_reduce": multi_reduce_reference,
             "snd_segment_sum": snd_segment_sum_reference,
             "csr_segment_sum": csr_segment_sum_reference}
    mods = {n: importlib.import_module(f"infomax3d_tpu_torch.ops.kernels.{n}")
            for n in public}
    pairs = {n: [] for n in mods}
    cases = [("multi_reduce", name, (rp, K), rp, E, widths)
             for name, rp, K, E, widths in recv_cases]
    cases += [("snd_segment_sum", name, (crp, perm), crp, E, widths)
              for name, crp, perm, E, widths in send_cases]
    cases += [("csr_segment_sum", name, (rp,), rp, E, widths)
              for name, rp, E, widths in seg_cases]
    for kern, name, idx, ptr, E, widths in cases:
        empty = (ptr[1:] - ptr[:-1]) == 0
        e_end = int(ptr[-1])
        _check(bool(empty.any()) and e_end < E,
               f"{kern} {name}: padding nodes and padding edges")
        if kern == "snd_segment_sum":
            _check(int(idx[1][:e_end].max()) < e_end,
                   f"{name}: a real sender position names a padding edge")
        paths = (("public wrapper", public[kern]),
                 ("64-bit indices", lambda *a, k=kern: mods[k]._launch(
                     *a, wide=True)))
        for D in widths:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(E, D, generator=gen, device="cuda").to(dt)
                ref = plain[kern](x, *idx)
                ref = ref if isinstance(ref, tuple) else (ref,)
                tag = f"{kern} {name} D={D} {dt} ({_vector_path(dt, D)} path)"
                for path, fn in paths:
                    got = fn(x, *idx)
                    got = got if isinstance(got, tuple) else (got,)
                    torch.cuda.synchronize()
                    for kk, rr in zip(got, ref):
                        _check(kk.dtype == rr.dtype and torch.equal(kk, rr),
                               f"{tag} {path}: not bit-exact")
                        _check(bool((kk[empty] == 0).all()),
                               f"{tag} {path}: nonzero on nodes without "
                               f"edges")
                        pairs[kern].append((kk, rr))
                x[e_end:] = 1e4
                again = public[kern](x, *idx)
                again = again if isinstance(again, tuple) else (again,)
                _check(all(torch.equal(a, r) for a, r in zip(again, ref)),
                       f"{tag}: a padding edge counted")
                print(f"[{phase}] {tag}: bit-exact through the "
                      + " and ".join(p for p, _ in paths)
                      + ", padding edges ignored")
    errs = {n: _max_err(p) for n, p in pairs.items() if p}
    for n, err in errs.items():
        print(f"[{phase}] {n}: agrees with its plain version (max |kernel - "
              f"plain| = {err:.3g})")
    return errs


def _merge_errs(errs: dict, new: dict):
    """Each kernel's largest max |kernel - plain| over the phases."""
    for n, err in new.items():
        errs[n] = max(errs.get(n, 0.0), err)


def _stats_cases(g):
    """(name, row_ptr, K, edges, D) on which phases 3 and 7 hold the two
    statistics kernels: the bench batch at its width (16-byte vectors), at
    D = 50 (bf16 rows of 100 bytes: one element per thread, 4-byte copies)
    and at D = 300 (8-byte vectors), and the degree-16 batch."""
    E = g.senders.shape[0]
    rp16, e16 = degree16_csr()
    return [("bench batch", g.csr_row_ptr, g.max_deg, E, D)
            for D in (WIDTH, OT_WIDTH, 300)] + [
        ("degree-16 batch", rp16, 16, e16, WIDTH)]


def _combine_path(dtype: torch.dtype, D: int, aligned: bool = True) -> str:
    """The instantiation the edge combine's launcher picks
    (csrc/edge_combine.cu): hd / hs gathered in `vec_width` pieces, pe and
    the output moved in flat 16-byte words where both are 16-byte aligned,
    else element by element."""
    if not aligned:
        return "element-wise gathers and words"
    return f"{_vector_path(dtype, D)} gathers, 16-byte words"


def _shifted(x):
    """x's elements from the second on, as a contiguous [rows - 1, D] view
    whose data starts 2 or 4 bytes past a 16-byte boundary: the launchers'
    unaligned paths."""
    rows, D = x.shape
    return x.view(-1)[1:1 + (rows - 1) * D].view(rows - 1, D)


def _hold_edge_combine(phase: str, gen, g, widths) -> list:
    """Row 6 (`edge_combine`) against its plain version on `g`'s edges at
    each width, bf16 and float32, on every path its launcher picks: the
    public wrapper; the raw launch with 64-bit indices forced; the first
    E - 1 edges (a run that is not a whole number of 16-byte words where a
    row is not: its last word moves piece by piece); and pe shifted by one
    element (not 16-byte aligned: element-wise gathers and words).  All
    sum the same float32 terms in the same order and round once ->
    bit-exact.  Padding edges (ids N), their pe rows set to 1e4, must get
    pe alone.  Returns the (kernel, plain) pairs."""
    mod = importlib.import_module(
        "infomax3d_tpu_torch.ops.kernels.edge_combine")
    N, E = g.num_nodes, g.senders.shape[0]
    pad = ~g.edge_mask
    _check(bool(pad.any()), f"edge_combine {phase}: padding edges")
    r, s = g.receivers, g.senders
    pairs = []
    for D in widths:
        for dt in (torch.bfloat16, torch.float32):
            hd, hs, pe = (torch.randn(n, D, generator=gen,
                                      device="cuda").to(dt)
                          for n in (N, N, E))
            pe[pad] = 1e4
            runs = (("public wrapper", edge_combine, (hd, hs, pe, r, s),
                     _combine_path(dt, D)),
                    ("64-bit indices",
                     lambda *a: mod._launch(*a, wide=True),
                     (hd, hs, pe, r, s), _combine_path(dt, D)),
                    (f"E - 1 = {E - 1} edges, {(E - 1) * D} elements",
                     edge_combine, (hd, hs, pe[:-1], r[:-1], s[:-1]),
                     _combine_path(dt, D)),
                    ("pe shifted by one element", edge_combine,
                     (hd, hs, _shifted(pe), r[:-1], s[:-1]),
                     _combine_path(dt, D, aligned=False)))
            for run, fn, args, path in runs:
                with torch.no_grad():
                    k = fn(*args)
                ref = edge_combine_reference(*args)
                torch.cuda.synchronize()
                tag = f"edge_combine {phase} D={D} {dt} {run} ({path})"
                _check(k.dtype == ref.dtype and torch.equal(k, ref),
                       f"{tag}: not bit-exact")
                pairs.append((k, ref))
                if run == "public wrapper":
                    _check(torch.equal(k[pad], pe[pad]),
                           f"{tag}: padding edges not pe alone")
            print(f"[{phase}] edge_combine D={D} {dt}: bit-exact through "
                  + ", ".join(f"{run} ({path})" for run, _, _, path in runs)
                  + "; padding edges get pe alone")
    return pairs


def _hold_pna_stats(phase: str, gen, cases) -> list:
    """Row 2 (`pna_stats`) against its plain version on each of `cases`
    (`_stats_cases`' tuples), with and without the affine and the sum
    section: every section bit-exact, degree-0 nodes 0.  Returns the
    (kernel, plain) pairs."""
    pairs = []
    for name, rp, k_deg, e_all, width in cases:
        x = torch.randn(e_all, width, generator=gen,
                        device="cuda").bfloat16() * 2
        aff = (torch.rand(width, generator=gen, device="cuda") + 0.5,
               torch.randn(width, generator=gen, device="cuda") * 0.3)
        empty = (rp[1:] - rp[:-1]) == 0
        for affine in (None, aff):
            for want_sum in (True, False):
                k = pna_stats(x, rp, k_deg, affine, want_sum)
                r = pna_stats_reference(x, rp, k_deg, affine, want_sum)
                torch.cuda.synchronize()
                tag = (f"pna_stats {name} D={width} "
                       f"({_vector_path(torch.bfloat16, width)} path) "
                       f"affine={affine is not None} sum={want_sum}")
                _check((k[0] is None) == (not want_sum),
                       tag + ": sum section")
                for sec, kk, rr in zip(("sum", "mean", "std", "max", "min",
                                        "enc"), k, r):
                    if kk is None:
                        continue
                    _check(torch.equal(kk, rr), f"{tag}: {sec} not exact")
                    if sec != "enc":
                        _check(bool((kk[empty] == 0).all()),
                               f"{tag}: {sec} nonzero on degree-0 nodes")
                    pairs.append((kk, rr))
        print(f"[{phase}] pna_stats {name} D={width} (K={k_deg}): every "
              f"section bit-exact, with and without the affine and the sum")
    return pairs


def phase_kernels(g) -> dict:
    N, E, D, K = g.num_nodes, g.senders.shape[0], WIDTH, g.max_deg
    print(f"[kernels] N={N} E={E} (real {int(g.csr_row_ptr[-1])}) D={D} "
          f"K={K}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    deg0 = (g.csr_row_ptr[1:] - g.csr_row_ptr[:-1]) == 0
    _check(bool(deg0.any()), "bench batch has padding nodes")
    errs = {"edge_combine": _max_err(_hold_edge_combine("kernels", gen, g,
                                                        COMBINE_WIDTHS)),
            "pna_stats": _max_err(_hold_pna_stats("kernels", gen,
                                                  _stats_cases(g)))}
    rp16, e16 = degree16_csr()
    crp16, perm16, s16 = degree16_csc()
    errs.update(_hold_walks(
        "kernels", gen,
        [("bench batch", g.csr_row_ptr, K, E, (WIDTH, 300, 302)),
         ("degree-16 batch", rp16, 16, e16, (WIDTH, OT_WIDTH)),
         ("degree-16 batch cut at K=3", rp16, 3, e16, (WIDTH, OT_WIDTH))],
        [("bench batch", g.csc_row_ptr, g.csc_perm, E, (WIDTH, 300, 302)),
         ("out-degree-16 batch", crp16, perm16, s16, (WIDTH, OT_WIDTH))]))
    for name, err in errs.items():
        print(f"[kernels] {name}: agrees with its plain version "
              f"(max |kernel - plain| = {err:.3g})")
    return errs


def _counts():
    return {n: w.launches for n, w in WRAPPERS.items()}


def _reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def phase_slice(out_dir: Path) -> dict:
    """The serving main path: 2 requests x {bf16, f32} through
    `inference()`; the counts are set to 0 first and read at the end."""
    jax_vars = dict(zip(("params", "batch_stats"),
                        init_jax_variables(MODEL_PARAMETERS, seed=0)))
    _reset_counts()
    for bf16 in (True, False):
        for seed in (0, 1):
            args = {"model_parameters": MODEL_PARAMETERS,
                    "bf16_compute": bf16, "batch_size": BATCH,
                    "dataset_params": dict(DATA, seed=seed),
                    "jax_variables": jax_vars,
                    "output_path": str(out_dir / f"fp_{bf16}_{seed}.npy")}
            before = _counts()
            fp = inference(args)                       # on the card
            after = _counts()
            delta = {n: after[n] - before[n] for n in after}
            _check(delta == EXPECTED[bf16],
                   f"launches per forward {delta} != {EXPECTED[bf16]}")
            ref = inference(dict(args, output_path=str(
                out_dir / f"fp_cpu_{bf16}_{seed}.npy")), device="cpu")
            _check(fp.shape == (BATCH, MODEL_PARAMETERS["target_dim"]),
                   f"fingerprint shape {fp.shape}")
            _check(bool(np.isfinite(fp).all()), "non-finite fingerprints")
            rel = float(np.abs(fp - ref).max() / np.abs(ref).max())
            _check(rel <= SLICE_TOL[bf16],
                   f"card vs CPU {rel:.3g} > {SLICE_TOL[bf16]}")
            print(f"[slice] bf16={bf16} request seed={seed}: {fp.shape} "
                  f"max|ref|={np.abs(ref).max():.4g} card-vs-CPU rel "
                  f"{rel:.3g} (tol {SLICE_TOL[bf16]}); launches {delta}")
    launches = _counts()
    print(f"[slice] serving main-path launches: {launches}")
    return launches


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Host-and-device rate: CUDA events around `iters` back-to-back calls
    (what a caller that issues them one after another sees)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ~50 ms at the H100's top SM clock: longer than the host takes to enqueue
# the timed calls, so none of the host's launch time falls inside the events
SLEEP_CYCLES = 100_000_000


def device_ms(fn, iters: int, warmup: int = 3, flush=None) -> float:
    """Device time per call: a sleep kernel holds the stream while the host
    enqueues the calls, so the events time their execution alone.  With
    `flush` (a 64 MB buffer), L2 is overwritten before each call, each call
    is timed alone, and the median is returned (cold-L2 time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_forward_time(g) -> dict:
    ms = {}
    for bf16 in (True, False):
        model = build_model({"model_parameters": MODEL_PARAMETERS,
                             "bf16_compute": bf16}, torch.device("cuda"))
        with torch.inference_mode():
            t = cuda_ms(lambda: model(g), iters=20)
        ms[bf16] = t
        print(f"[slice] forward bf16={bf16}: {t:.4f} ms, "
              f"{BATCH / t * 1e3:.1f} graphs/s (batch {BATCH}, CUDA events "
              f"over 20 warm forwards)")
    return ms


def phase_profile(g, fwd_ms: dict, n: int = 5):
    """Where a forward's time goes: torch.profiler's CUDA kernel records
    over `n` warm forwards -> device-busy ms per forward, the idle share of
    the CUDA-event forward time, kernels per forward, the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    for bf16 in (True, False):
        model = build_model({"model_parameters": MODEL_PARAMETERS,
                             "bf16_compute": bf16}, torch.device("cuda"))
        with torch.inference_mode():
            for _ in range(3):
                model(g)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    model(g)
                torch.cuda.synchronize()
        by_name = _profile_kernels(prof)
        if not by_name:
            print(f"[profile] bf16={bf16}: the profiler recorded no device "
                  f"activity; not measured")
            continue
        busy = sum(us for us, _ in by_name.values()) / n / 1e3
        kernels = sum(c for _, c in by_name.values()) / n
        print(f"[profile] bf16={bf16}: device busy {busy:.4f} ms of "
              f"{fwd_ms[bf16]:.4f} ms per forward (idle share "
              f"{1 - busy / fwd_ms[bf16]:.3f}), {kernels:.0f} kernels per "
              f"forward")
        for kname, (us, launches) in _port_kernels(by_name).items():
            print(f"[profile]   {kname}: {us / launches:.2f} us per launch "
                  f"in the forward, {launches / n:.0f} launches per forward")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for name, (us, cnt) in top:
            print(f"[profile]   {us / n:9.2f} us/fwd  {cnt / n:5.0f}x  "
                  f"{name[:90]}")


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_times(g, launches: dict, errs: dict) -> list:
    """Each kernel's main-path variant at the bench shapes: the bf16
    combine, the stats with the folded affine and no sum section (the
    flagship reads no sum), and the float32 multi-reduce."""
    N, E, D, K = g.num_nodes, g.senders.shape[0], WIDTH, g.max_deg
    e_real = int(g.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    hd, hs, pe = randn(N, D).to(bf), randn(N, D).to(bf), randn(E, D).to(bf)
    xb = randn(E, D).to(bf)
    aff = (torch.rand(D, generator=gen, device="cuda") + 0.5, randn(D))
    xf = randn(E, D)
    rp = g.csr_row_ptr
    idx_bytes = 2 * E * 4
    cases = {
        # two gathered node arrays, pe and the output; 2 adds per element
        "edge_combine": (
            lambda: edge_combine(hd, hs, pe, g.receivers, g.senders),
            lambda: edge_combine_reference(hd, hs, pe, g.receivers,
                                           g.senders),
            2 * N * D * 2 + E * D * 2 + idx_bytes + E * D * 2,
            2.0 * E * D, "bf16"),
        # the real message rows, row_ptr, the affine, 5 bf16 sections out;
        # per message element: affine 2, sum 1, sumsq 2, max/min 2;
        # per output element ~8 (mean, var, sqrt, masks)
        "pna_stats": (
            lambda: pna_stats(xb, rp, K, aff, False),
            lambda: pna_stats_reference(xb, rp, K, aff, False),
            e_real * D * 2 + (N + 1) * 4 + 2 * D * 4 + 5 * N * D * 2,
            7.0 * e_real * D + 8.0 * N * D, "bf16, affine, no sum"),
        # the real message rows, row_ptr, 4 float32 sections out;
        # per message element: sum 1, sumsq 2, max/min 2
        "multi_reduce": (
            lambda: multi_reduce(xf, rp, K),
            lambda: multi_reduce_reference(xf, rp, K),
            e_real * D * 4 + (N + 1) * 4 + 4 * N * D * 4,
            5.0 * e_real * D, "float32"),
    }
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for name, (kern, plain, nbytes, flops, variant) in cases.items():
        warm = device_ms(kern, iters=100, warmup=10)
        # the bound reads every input from device memory, so the kernel's
        # reported time is the cold-L2 one (warm inputs can sit in the 50 MB
        # L2 and beat the memory-rate bound)
        ms = device_ms(kern, iters=20, flush=flush)
        plain_ms = device_ms(plain, iters=10)
        host_ms = cuda_ms(kern, iters=100)
        bound_ms, bound_by = _bound(nbytes, flops)
        src, replaces = KERNEL_INFO[name]
        print(f"[times] {name} ({variant}; __global__ "
              f"{PROFILE_NAMES[name][0]}): device {ms:.5f} ms cold-L2 "
              f"median, {warm:.5f} ms warm; back-to-back with the host's "
              f"launch {host_ms:.5f} ms; plain {plain_ms:.5f} ms; bound {bound_ms:.5f} ms by {bound_by} "
              f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP f32; "
              f"H100 SXM peaks {PEAK_BYTES_PER_S / 1e12} TB/s, "
              f"{PEAK_F32_FLOPS / 1e12} TFLOP/s f32); no single PyTorch "
              f"call computes it, library_ms null")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": LIBRARY_MS})
    return rows


def _stats_bwd_inputs(rp, K, E, D, gen, missing=()):
    """The stats backward's inputs on the card: bf16 messages, an affine,
    the forward's mean / std / enc (the stats kernel's, with the affine and
    no sum section, as the flagship step runs it) and the five cotangents
    of (sum, mean, std, max, min), bf16, None where `missing` names them."""
    N = rp.shape[0] - 1
    x = (torch.randn(E, D, generator=gen, device="cuda") * 2).bfloat16()
    aff = (torch.rand(D, generator=gen, device="cuda") + 0.5,
           torch.randn(D, generator=gen, device="cuda") * 0.3)
    with torch.no_grad():
        _, mean, std, _, _, enc = pna_stats(x, rp, K, aff, False)
    cts = {n: None if n in missing else torch.randn(
        N, D, generator=gen, device="cuda").bfloat16() for n in COTANGENTS}
    return x, aff, (mean, std, enc), cts


# cotangent sets of phase 7: all five, the flagship's (no sum section), and
# the std and extremum terms alone
BWD_MISSING = {"all": (), "no sum": ("d_sum",),
               "std, max, min": ("d_sum", "d_mean")}


def _hold_pair_segment_sum(phase: str, gen, g, widths) -> list:
    """Row 5 (`pair_segment_sum`) against its plain version on `g`'s CSR
    and CSC arrays at each width, bf16 and float32, on every path its
    launcher picks: the public wrapper; the raw launch with 64-bit indices
    forced; ct shifted by one element (not 16-byte aligned: one element per
    thread; csc_perm without its last entry, a padding edge's).  All sum
    the same rows in float32 in slot order and round once -> bit-exact;
    nodes without edges get 0.  Then the padding rows of ct set to 1e4
    must leave the public wrapper's result as it was.  Returns the
    (kernel, plain) pairs."""
    mod = importlib.import_module(
        "infomax3d_tpu_torch.ops.kernels.pair_segment_sum")
    E = g.senders.shape[0]
    rp, crp, perm = g.csr_row_ptr, g.csc_row_ptr, g.csc_perm
    e_real = int(rp[-1])
    _check(e_real < E and int(perm[:e_real].max()) < e_real,
           f"pair_segment_sum {phase}: padding edges, real positions")
    empty = ((rp[1:] - rp[:-1]) == 0, (crp[1:] - crp[:-1]) == 0)
    pairs = []
    for D in widths:
        for dt in (torch.bfloat16, torch.float32):
            ct = torch.randn(E, D, generator=gen, device="cuda").to(dt)
            runs = (("public wrapper", pair_segment_sum, (ct, rp, crp, perm),
                     _vector_path(dt, D)),
                    ("64-bit indices",
                     lambda *a: mod._launch(*a, wide=True),
                     (ct, rp, crp, perm), _vector_path(dt, D)),
                    ("ct shifted by one element", pair_segment_sum,
                     (_shifted(ct), rp, crp, perm[:-1]), "element-wise"))
            for run, fn, args, path in runs:
                k = fn(*args)
                ref = pair_segment_sum_reference(*args)
                torch.cuda.synchronize()
                tag = f"pair_segment_sum {phase} D={D} {dt} {run} ({path})"
                for half, kk, rr, mt in zip(("d_hd", "d_hs"), k, ref, empty):
                    _check(kk.dtype == rr.dtype and torch.equal(kk, rr),
                           f"{tag} {half}: not bit-exact")
                    _check(bool((kk[mt] == 0).all()),
                           f"{tag} {half}: nonzero on nodes without edges")
                    pairs.append((kk, rr))
                if run == "public wrapper":
                    want = k
            ct[e_real:] = 1e4
            again = pair_segment_sum(ct, rp, crp, perm)
            _check(all(torch.equal(a, w) for a, w in zip(again, want)),
                   f"pair_segment_sum {phase} D={D} {dt}: a padding edge "
                   f"counted")
            print(f"[{phase}] pair_segment_sum D={D} {dt}: bit-exact "
                  f"through " + ", ".join(f"{run} ({path})"
                                          for run, _, _, path in runs)
                  + "; padding edges ignored")
    return pairs


def _hold_pna_stats_bwd(phase: str, gen, cases) -> list:
    """Row 8 (`pna_stats_bwd`) against its plain version on each of
    `cases` (`_stats_cases`' tuples), for each cotangent set of
    BWD_MISSING, with and without the affine, on the forward kernel's
    residuals: d_x bit-exact (the same rounding points), padding edges 0;
    d_a / d_b (float32 column sums in the kernel's order) within 1e-6 of
    max|plain|, reported when exact.  Returns the (kernel, plain) pairs."""
    pairs = []
    for name, rp, k_deg, e_all, width in cases:
        e_real = int(rp[-1])
        for cset, missing in BWD_MISSING.items():
            x, aff, res, cts = _stats_bwd_inputs(rp, k_deg, e_all, width, gen,
                                                 missing)
            for affine in (None, aff):
                args = (x, rp, k_deg, *res, *cts.values(), affine)
                k, r = pna_stats_bwd(*args), pna_stats_bwd_reference(*args)
                torch.cuda.synchronize()
                tag = (f"pna_stats_bwd {name} D={width} "
                       f"({_vector_path(torch.bfloat16, width)} path) "
                       f"cotangents {cset} affine={affine is not None}")
                _check(torch.equal(k[0], r[0]), f"{tag}: d_x not bit-exact")
                _check(bool((k[0][e_real:] == 0).all()),
                       f"{tag}: padding edges not 0")
                pairs.append((k[0], r[0]))
                if affine is None:
                    _check(k[1] is None and k[2] is None,
                           f"{tag}: column sums")
                    continue
                for sec, kk, rr in zip(("d_a", "d_b"), k[1:], r[1:]):
                    err = float((kk - rr).abs().max())
                    _check(err <= 1e-6 * float(rr.abs().max()),
                           f"{tag}: {sec} off by {err:.3g}")
                    pairs.append((kk, rr))
                print(f"[{phase}] {tag}: d_x bit-exact, d_a / d_b "
                      + ("bit-exact" if all(torch.equal(kk, rr) for kk, rr
                                            in zip(k[1:], r[1:]))
                         else f"within {_max_err(zip(k[1:], r[1:])):.3g}"))
    return pairs


def phase_train_kernels(g) -> dict:
    """Phase 7: the backward kernels against their plain versions on the
    same CUDA tensors (`_hold_pair_segment_sum` at the bench batch,
    `_hold_pna_stats_bwd` on the cases of phase 3); the kernel leaves its
    counters at 0.  Then the stats backward on two streams at once
    (`_stats_bwd_on_two_streams`)."""
    from infomax3d_tpu_torch.ops.kernels.pna_stats_bwd import _COUNTERS
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {"pair_segment_sum": _max_err(_hold_pair_segment_sum(
        "train-kernels", gen, g, COMBINE_WIDTHS))}
    pairs = _hold_pna_stats_bwd("train-kernels", gen, _stats_cases(g))
    errs_two = _stats_bwd_on_two_streams(g, gen)
    _check(all(int(c.abs().sum()) == 0 for c in _COUNTERS.values()),
           "pna_stats_bwd left a counter non-zero")
    pairs += errs_two
    errs["pna_stats_bwd"] = _max_err(pairs)
    for name, err in errs.items():
        print(f"[train-kernels] {name}: agrees with its plain version "
              f"(max |kernel - plain| = {err:.3g})")
    return errs


def _stats_bwd_on_two_streams(g, gen, rounds: int = 8) -> list:
    """The stats backward with the affine on two streams of the card at
    once: two cases at the bench shapes, launched `rounds` times each in
    turns, one stream each.  Every result is held as in phase 7 (d_x bit
    for bit, d_a / d_b within 1e-6 of max|plain|) against its plain
    version, and each stream must have had counters of its own: shared
    ones would let one launch's blocks count the other's chunks.  Returns
    the (kernel, plain) pairs."""
    from infomax3d_tpu_torch.ops.kernels.pna_stats_bwd import _COUNTERS
    rp, K, E, D = g.csr_row_ptr, g.max_deg, g.senders.shape[0], WIDTH
    cases = []
    for _ in range(2):
        x, aff, res, cts = _stats_bwd_inputs(rp, K, E, D, gen, ("d_sum",))
        args = (x, rp, K, *res, *cts.values(), aff)
        cases.append((args, pna_stats_bwd_reference(*args)))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(rounds):
        for (args, _), s, out in zip(cases, streams, outs):
            with torch.cuda.stream(s):
                out.append(pna_stats_bwd(*args))
    torch.cuda.synchronize()
    pairs = []
    for i, ((_, ref), out) in enumerate(zip(cases, outs)):
        for k in out:
            _check(torch.equal(k[0], ref[0]),
                   f"pna_stats_bwd on stream {i}: d_x not bit-exact")
            for sec, kk, rr in zip(("d_a", "d_b"), k[1:], ref[1:]):
                err = float((kk - rr).abs().max())
                _check(err <= 1e-6 * float(rr.abs().max()),
                       f"pna_stats_bwd on stream {i}: {sec} off by {err:.3g}")
            pairs += list(zip(k, ref))
    handles = {s.cuda_stream for s in streams}
    _check(len({key for key in _COUNTERS if key[1] in handles}) == 2,
           "pna_stats_bwd: the two streams did not get counters of their own")
    print(f"[train-kernels] pna_stats_bwd on two streams at once ({rounds} "
          f"launches each, in turns): every result agrees with its plain "
          f"version (max |kernel - plain| = {_max_err(pairs):.3g}), one set "
          f"of counters per stream")
    return pairs


def _train_args(bf16: bool) -> dict:
    return {"model_parameters": MODEL_PARAMETERS,
            "model3d_parameters": MODEL3D_PARAMETERS,
            "loss_params": LOSS_PARAMS, "optimizer_params": OPTIMIZER_PARAMS,
            "batch_size": BATCH, "bf16_compute": bf16, "seed": 0,
            "dataset_params": {"seed": 0, "n_min": DATA["n_min"],
                               "n_max": DATA["n_max"]}}


def _measure_step(step, models: dict, batches: tuple, perturb: float = 0.0,
                  **kw):
    """(loss, every parameter's gradient (None where it got none) and
    every running statistic, on the CPU, named ``<model>.<name>``) of one
    step of `step` on prepared `batches` (`kw` to its `loss_and_grads`:
    a noise source); `models` maps each model's name to the module.  With
    `perturb`, every master weight is scaled by 1 + perturb * U(-1, 1)
    first."""
    if perturb:
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for m in models.values():
                for p in m.parameters():
                    u = torch.rand(p.shape, generator=gen) * 2 - 1
                    p.mul_(1 + perturb * u.to(p.device))
    loss = float(step.loss_and_grads(*batches, **kw))
    out = {}
    for pre, m in models.items():
        out.update({f"{pre}.{n}": None if p.grad is None
                    else p.grad.float().cpu()
                    for n, p in m.named_parameters()})
        # a copy: a CPU rehearsal's buffers are the live ones
        out.update({f"{pre}.{n}": b.float().cpu().clone()
                    for n, b in m.named_buffers() if "running" in n})
    return loss, out


# The card against the CPU, one step from the same weights and batch.  Both
# run the port; they differ in summation order (cuBLAS against the CPU's
# GEMMs, the CUDA reductions) and, in bf16, in where those sums round.
# Both steps on the card are held to the CPU's float32 step.  Errors are
# relative to each leaf's max|CPU float32|; the gradient's L2 is taken over
# each model.  Every leaf but the zero-gradient ones (below) must have a
# non-zero gradient on both sides.  float32: STEP_TOL[False].  bf16: the
# CPU's own bf16 step, read against the same float32 step, sets the limits
# (`_bf16_limits`): the loss, each leaf, each model's L2 and the running
# statistics within BF16_FACTOR times that reading (each leaf: its model's
# worst leaf), never tighter than STEP_TOL[True]; the zero-gradient leaves
# within STEP_TOL[True]["zero"].
# The card's bf16 step may stray from float32 as far as the CPU's bf16 step
# does, with room for its other summation order, and no farther.
# Readings (NVIDIA H100 80GB HBM3, 700 W), the pre-training step: bf16 card
# / CPU loss 6.0e-5 / 8.1e-5, PNA L2 0.293 / 0.310, Net3DDense 0.151 /
# 0.149, worst leaf 0.914 / 0.975, zero-gradient leaves 3.1e-3, statistics
# 6.9e-3; planted faults: zeroed d_a, d_b leave 14 leaves without gradient,
# the d_max / d_min routing dropped reads PNA L2 0.827 (limit 0.621);
# float32 loss 0, worst leaf 6.9e-3, L2 8.8e-4, statistics 3.3e-6.  The GIN
# step (phase 12): bf16 loss 2.75e-3 on both, L2 0.107 / 0.107, worst leaf
# 0.436 / 0.448; its planted fault (a zeroed gather backward) L2 0.878
# (limit 0.215); float32 loss 6.3e-8, worst leaf 4.9e-3, L2 9.2e-5.
# "zero": the zero-gradient leaves (below), of the model's largest gradient
STEP_TOL = {True: {"loss": 1e-3, "leaf": 0.6, "l2": 5e-3, "zero": 1e-2,
                   "stats": 2e-2},
            False: {"loss": 1e-5, "leaf": 5e-2, "l2": 5e-3, "zero": 1e-4,
                    "stats": 1e-4}}
BF16_FACTOR = 2.0
# Leaves with an exactly zero gradient: a Linear bias or BatchNorm shift
# feeding a BatchNorm with no nonlinearity between (the normalization
# removes any per-column constant).  Both sides hold rounding noise there,
# held below STEP_TOL's "zero" share of the model's largest gradient.
ZERO_GRADIENT = ("pretrans.fully_connected.0.batch_norm.bias",
                 "pretrans.fully_connected.1.linear.bias",
                 "posttrans.fully_connected.0.linear.bias",
                 "update_network.fully_connected.0.linear.bias",
                 "mlp.0.bias", "mlp.3.bias")


def _readings(card: dict, cpu: dict, sides: tuple,
              zero_leaves: tuple = ZERO_GRADIENT) -> dict:
    """Per model: each leaf's error (of its max) and the worst, the worst
    leaf of `zero_leaves` (of the model's max gradient), the gradient's
    L2, the worst running statistic (0 without any), and the leaves whose
    gradient is missing, non-finite or zero on either side."""
    out = {}
    for side in sides:
        keys = [k for k in cpu if k.startswith(side + ".")
                and "running" not in k]
        gmax = max(float(cpu[k].abs().max()) for k in keys)
        leaves, zero, dead = {}, (0.0, None), []
        for k in keys:
            for which in (card, cpu):
                g = which[k]
                if g is None or not bool(torch.isfinite(g).all()) or not (
                        k.endswith(zero_leaves) or float(g.abs().max()) > 0):
                    dead.append(k)
            if k in dead:
                continue
            if k.endswith(zero_leaves):
                zero = max(zero, (max(float(card[k].abs().max()),
                                      float(cpu[k].abs().max())) / gmax, k),
                           key=lambda e: e[0])
                continue
            leaves[k] = (float((card[k] - cpu[k]).abs().max())
                         / float(cpu[k].abs().max()))
        live = [k for k in keys if k not in dead]
        fc = torch.cat([card[k].flatten() for k in live])
        fr = torch.cat([cpu[k].flatten() for k in live])
        skeys = [k for k in cpu if k.startswith(side + ".") and "running" in k]
        out[side] = {
            "leaves": leaves,
            "leaf": max(((e, k) for k, e in leaves.items()),
                        default=(0.0, None)),
            "zero": zero, "dead": sorted(set(dead)),
            "l2": float((fc - fr).norm() / fr.norm()),
            "stats": max((float((card[k] - cpu[k]).abs().max())
                          / max(float(cpu[k].abs().max()), 1.0)
                          for k in skeys), default=0.0)}
    return out


def _violations(r: dict, tol: dict, l2_tol: dict, leaf_tol=None) -> list:
    """What the readings `r` break of a step check: the worst leaf against
    tol["leaf"] (or, given `leaf_tol`, each leaf against its own bound),
    the zero-gradient leaves against tol["zero"], each side's L2 against
    `l2_tol` and the running statistics against tol["stats"]."""
    bad = []
    for side, d in r.items():
        bad += [f"{k}: no finite non-zero gradient" for k in d["dead"]]
        if leaf_tol is None:
            if d["leaf"][0] > tol["leaf"]:
                bad.append(f"{d['leaf'][1]}: {d['leaf'][0]:.3g}")
        else:
            bad += [f"{k}: {e:.3g} > {leaf_tol[k]:.3g}"
                    for k, e in d["leaves"].items() if e > leaf_tol[k]]
        if d["zero"][0] > tol["zero"]:
            bad.append(f"{d['zero'][1]}: zero-gradient leaf at "
                       f"{d['zero'][0]:.3g}")
        if d["l2"] > l2_tol[side]:
            bad.append(f"{side} gradient L2 {d['l2']:.3g}")
        if d["stats"] > tol["stats"]:
            bad.append(f"{side} running statistics {d['stats']:.3g}")
    return bad


def _print_readings(tag: str, r: dict, l2_tol: dict, phase: str):
    for side, d in r.items():
        print(f"[{phase}] {tag} {side}: worst leaf {d['leaf'][0]:.3g} "
              f"({d['leaf'][1]}), zero-gradient leaves {d['zero'][0]:.3g}, "
              f"gradient L2 {d['l2']:.3g} (tol {l2_tol[side]:.3g}), running "
              f"statistics {d['stats']:.3g}, leaves without gradient "
              f"{len(d['dead'])}")


def _one_step(bf16: bool, dev: str, g2, g3):
    """`_measure_step` of one pre-training step from the seeded
    weights."""
    step = build_step(_train_args(bf16), torch.device(dev))
    return _measure_step(step, {"model": step.model,
                                "model3d": step.model3d},
                         step.prepare(g2, g3))


def _bf16_limits(own: dict, own_loss: float, floor: dict = None) -> tuple:
    """The bf16 step check's limits from the CPU's own bf16 step read
    against its float32 step (`own`, `_readings`; `own_loss`, relative):
    BF16_FACTOR times each reading, never below `floor` (STEP_TOL[True]);
    each leaf of a model within BF16_FACTOR times that model's worst leaf
    (a single leaf's reading, a max over a few hundred entries, is too
    noisy to scale).  Returns (tol, each side's L2 limit, each leaf's
    limit)."""
    floor = floor or STEP_TOL[True]
    tol = dict(floor, loss=max(floor["loss"], BF16_FACTOR * own_loss),
               stats=max(floor["stats"], BF16_FACTOR * max(
                   d["stats"] for d in own.values())))
    l2_tol = {s: max(floor["l2"], BF16_FACTOR * d["l2"])
              for s, d in own.items()}
    leaf_tol = collections.defaultdict(lambda: floor["leaf"])
    for d in own.values():
        worst = max(floor["leaf"], BF16_FACTOR * d["leaf"][0])
        leaf_tol.update({k: worst for k in d["leaves"]})
    return tol, l2_tol, leaf_tol


def _merge_own(own: dict, more: dict):
    """`own` readings (`_readings`) raised to `more`'s where larger."""
    for side, d in more.items():
        o = own[side]
        o["leaves"] = {n: max(e, d["leaves"].get(n, 0.0))
                       for n, e in o["leaves"].items()}
        o["leaf"] = max(o["leaf"], d["leaf"], key=lambda e: e[0])
        o["l2"], o["stats"] = max(o["l2"], d["l2"]), max(o["stats"],
                                                         d["stats"])


def _hold_step_against_cpu(one_step, sides: tuple, faults: dict,
                           phase: str, zero_leaves: tuple = ZERO_GRADIENT,
                           fault_bf16: bool = True, witnesses: int = 1,
                           f32_witnesses: int = 0):
    """One float32 and one bf16 step on the card against the CPU's float32
    step (`one_step(bf16, device)` gives `_measure_step`'s loss and
    leaves): the loss, every leaf, the L2 of each model's gradient and the
    running statistics, float32 by STEP_TOL[False], bf16 by `_bf16_limits`
    of the CPU's own bf16 step; `zero_leaves` are the model's
    zero-gradient leaves.  Then the check's own test: with each planted
    fault (`faults` maps its name to a `plant()` that returns its undo)
    the card's bf16 step must fail it (with `fault_bf16` False, the
    card's float32 step must fail the float32 check).  With `witnesses`
    n > 1 the CPU's own bf16 distance is the largest of n readings: the
    seeded weights', then the weights scaled by 1 + k * 2^-16 * U(-1, 1)
    (k = 1 .. n - 1: below bf16's resolution, so each rounds anew), each
    bf16 step against the float32 step at its own weights; `one_step`
    then takes `perturb`.  With `f32_witnesses` n > 0 the float32 check's
    limits are likewise BF16_FACTOR times the CPU's own float32 noise,
    never below STEP_TOL[False]: the largest distance of n CPU float32
    steps at weights scaled by 1 + k * 2^-20 * U(-1, 1) (k = 1 .. n) from
    the CPU float32 step (for models whose float32 step is
    ill-conditioned: a max or min aggregate whose winner flips, a std over
    near-constant columns)."""
    loss_ref, ref = one_step(False, "cpu")

    def against_ref(loss, leaves, tol, l2_tol, leaf_tol=None):
        r = _readings(leaves, ref, sides, zero_leaves)
        rel = abs(loss - loss_ref) / abs(loss_ref)
        bad = ([f"loss {rel:.3g}"] if rel > tol["loss"] else []) + \
            _violations(r, tol, l2_tol, leaf_tol)
        return r, rel, bad

    l2_32 = {s: STEP_TOL[False]["l2"] for s in sides}
    limits32 = (STEP_TOL[False], l2_32)
    if f32_witnesses:
        own32, own32_loss = None, 0.0
        for k in range(1, f32_witnesses + 1):
            lk, rk = one_step(False, "cpu", perturb=k * 2.0 ** -20)
            rk = _readings(rk, ref, sides, zero_leaves)
            own32_loss = max(own32_loss, abs(lk - loss_ref) / abs(loss_ref))
            print(f"[{phase}] float32 witness {k} (weights scaled by 1 + "
                  f"{k} * 2^-20 * U(-1, 1)): loss "
                  f"{abs(lk - loss_ref) / abs(loss_ref):.3g}"
                  + "".join(f", {side} L2 {d['l2']:.3g}, worst leaf "
                            f"{d['leaf'][0]:.3g}" for side, d in rk.items()))
            if own32 is None:
                own32 = rk
            else:
                _merge_own(own32, rk)
        limits32 = _bf16_limits(own32, own32_loss, STEP_TOL[False])
        l2_32 = limits32[1]
    loss, card = one_step(False, "cuda")
    r, rel, bad = against_ref(loss, card, *limits32)
    print(f"[{phase}] float32: loss card {loss:.6f} vs CPU {loss_ref:.6f}, "
          f"{rel:.3g} (tol {limits32[0]['loss']:.3g})")
    _print_readings("float32 card vs CPU", r, l2_32, phase)
    _check(not bad, f"float32 step card vs CPU: {bad}")

    loss_own, own = one_step(True, "cpu")
    own_loss = abs(loss_own - loss_ref) / abs(loss_ref)
    own = _readings(own, ref, sides, zero_leaves)
    for k in range(1, witnesses):
        l32, r32 = one_step(False, "cpu", perturb=k * 2.0 ** -16)
        l16, r16 = one_step(True, "cpu", perturb=k * 2.0 ** -16)
        rk = _readings(r16, r32, sides, zero_leaves)
        print(f"[{phase}] bf16 witness {k} (weights scaled by 1 + "
              f"{k} * 2^-16 * U(-1, 1)): loss {abs(l16 - l32) / abs(l32):.3g}"
              + "".join(f", {side} L2 {d['l2']:.3g}, worst leaf "
                        f"{d['leaf'][0]:.3g}" for side, d in rk.items()))
        own_loss = max(own_loss, abs(l16 - l32) / abs(l32))
        _merge_own(own, rk)
    limits = _bf16_limits(own, own_loss)
    print(f"[{phase}] bf16 CPU vs float32 CPU (the bf16 limits' base, x "
          f"{BF16_FACTOR:g}): loss {loss_own:.6f}, {own_loss:.3g}")
    _print_readings("bf16 CPU vs float32 CPU", own, limits[1], phase)
    loss, card = one_step(True, "cuda")
    r, rel, bad = against_ref(loss, card, *limits)
    print(f"[{phase}] bf16: loss card {loss:.6f} vs CPU float32 "
          f"{loss_ref:.6f}, {rel:.3g} (tol {limits[0]['loss']:.3g})")
    _print_readings("bf16 card vs float32 CPU", r, limits[1], phase)
    _check(not bad, f"bf16 step card vs CPU: {bad}")
    held = limits if fault_bf16 else limits32
    for fault, plant in faults.items():
        undo = plant()
        try:
            loss, card = one_step(fault_bf16, "cuda")
        finally:
            undo()
        r, rel, bad = against_ref(loss, card, *held)
        _print_readings(f"planted fault ({fault}), "
                        f"{'bf16' if fault_bf16 else 'float32'} card vs "
                        f"float32 CPU", r, held[1], phase)
        print(f"[{phase}] planted fault ({fault}): loss {rel:.3g}, "
              f"{len(bad)} violations, e.g. {bad[:2]}")
        _check(bool(bad), f"the step check passed a planted fault "
                          f"({fault})")


def _zeroed_affine_cotangents():
    """A planted fault for the step check's own test: the stats backward
    returns zero affine cotangents (d_a, d_b).  Returns the undo."""
    mod = importlib.import_module("infomax3d_tpu_torch.ops.kernels.pna_stats")
    real = mod.pna_stats_bwd

    def zeroed(*args):
        d_x, d_a, d_b = real(*args)
        return d_x, *(None if d is None else torch.zeros_like(d)
                      for d in (d_a, d_b))
    mod.pna_stats_bwd = zeroed
    return lambda: setattr(mod, "pna_stats_bwd", real)


def _dropped_extremum_routing():
    """The second planted fault: the stats backward drops only the d_max /
    d_min terms (their cotangents passed as None, the kernel's "missing"),
    so no edge receives the max and min aggregators' gradient.  Returns
    the undo."""
    mod = importlib.import_module("infomax3d_tpu_torch.ops.kernels.pna_stats")
    real = mod.pna_stats_bwd
    at = 6 + COTANGENTS.index("d_max")        # x, row_ptr, K, 3 residuals

    def dropped(*args):
        return real(*args[:at], None, None, *args[at + 2:])
    mod.pna_stats_bwd = dropped
    return lambda: setattr(mod, "pna_stats_bwd", real)


def phase_train(smi: str) -> dict:
    """Phase 8: the training main path and its checks.  Returns the
    main-path launches, the step times and the batch sizes."""
    _reset_counts()
    runs = {}
    for bf16 in (True, False):
        before = _counts()
        out = pretrain(_train_args(bf16), steps=TRAIN_STEPS)   # on the card
        after = _counts()
        per_step = {n: (after[n] - before[n]) / TRAIN_STEPS for n in after}
        _check(per_step == EXPECTED_STEP[bf16],
               f"launches per step {per_step} != {EXPECTED_STEP[bf16]}")
        losses = out["losses"]
        _check(all(np.isfinite(losses)), f"non-finite losses {losses}")
        _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        print(f"[train] bf16={bf16}: {TRAIN_STEPS} steps through pretrain(), "
              f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; launches per step "
              f"{per_step}")
        runs[bf16] = out
    launches = _counts()
    print(f"[train] training main-path launches: {launches}")

    # one step on the card and on the CPU from the same weights and batch
    sizes = runs[True]["sizes"]
    g2, g3, _ = flagship_batches(BATCH, seed=0, n_min=DATA["n_min"],
                                 n_max=DATA["n_max"])
    _hold_step_against_cpu(
        lambda bf16, dev: _one_step(bf16, dev, g2, g3),
        ("model", "model3d"),
        {"zeroed d_a, d_b": _zeroed_affine_cotangents,
         "d_max / d_min routing dropped": _dropped_extremum_routing},
        "train")

    # warm steps on the card: CUDA events around back-to-back steps
    step_ms = {}
    for bf16 in (True, False):
        step = build_step(_train_args(bf16), torch.device("cuda"))
        a, b = step.prepare(g2.to("cuda"), g3.to("cuda"))
        t = cuda_ms(lambda: step.step(a, b), iters=20)
        step_ms[bf16] = t
        print(f"[train] step bf16={bf16}: {t:.4f} ms, "
              f"{BATCH / t * 1e3:.1f} graphs/s, "
              f"{(sizes['edges_2d'] + sizes['edges_3d']) / t * 1e3:.1f} "
              f"edges/s ({sizes['edges_2d']} 2D bond + {sizes['edges_3d']} "
              f"3D complete-graph edges per step; CUDA events over 20 warm "
              f"steps; {smi})")
    return {"launches": launches, "step_ms": step_ms, "sizes": sizes,
            "batches": (g2, g3)}


def _profile_kernels(prof):
    from torch.profiler import DeviceType
    by_name = {}
    for e in prof.events():
        # device records only: kernels and copies, not the spans of
        # annotated host ranges (such as the optimizer's step)
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            us, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    return by_name


# kernel names of each wrapper in a profile (a call launches one of them)
PROFILE_NAMES = {"edge_combine": ("edge_combine_kernel",),
                 "pna_stats": ("pna_stats_kernel",),
                 "multi_reduce": ("multi_reduce_kernel",),
                 "pair_segment_sum": ("pair_segment_sum_kernel",),
                 "pna_stats_bwd": ("pna_stats_bwd_kernel",),
                 "csr_sum": ("csr_sum_kernel", "csr_sum_stream_kernel"),
                 "snd_segment_sum": ("snd_segment_sum_kernel",),
                 "csr_segment_sum": ("csr_segment_sum_kernel",)}


def _port_kernels(by_name: dict) -> dict:
    """{wrapper: (device us, launches)} of the port's kernels in a
    profile."""
    out = {}
    for kname, needles in PROFILE_NAMES.items():
        hits = [(us, c) for nm, (us, c) in by_name.items()
                if any(nd in nm for nd in needles)]
        if hits:
            us, c = map(sum, zip(*hits))
            out[kname] = (us, c)
    return out


def _print_globals(by_name: dict, n: int, phase: str):
    """Each `__global__` of the port's kernels in a profile on its own
    line (a wrapper's time split by kernel)."""
    needles = [nd for nds in PROFILE_NAMES.values() for nd in nds]
    for name, (us, cnt) in sorted(by_name.items()):
        if any(nd in name for nd in needles):
            print(f"[{phase}]     __global__ {name[:80]}: {us / cnt:.2f} us "
                  f"per launch, {cnt / n:.0f} per step")


def phase_train_profile(train: dict, n: int = 5) -> dict:
    """Phase 9: torch.profiler's CUDA kernel records over `n` warm bf16
    steps -> device-busy ms per step, the idle share of the CUDA-event step
    time, kernels per step, the port's kernels and the top kernels.
    Returns each port kernel's in-step us per launch."""
    from torch.profiler import ProfilerActivity, profile
    g2, g3 = train["batches"]
    step = build_step(_train_args(True), torch.device("cuda"))
    a, b = step.prepare(g2.to("cuda"), g3.to("cuda"))
    for _ in range(3):
        step.step(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step.step(a, b)
        torch.cuda.synchronize()
    by_name = _profile_kernels(prof)
    in_step = {}
    if not by_name:
        print("[train-profile] the profiler recorded no device activity; "
              "not measured")
        return in_step
    busy = sum(us for us, _ in by_name.values()) / n / 1e3
    kernels = sum(c for _, c in by_name.values()) / n
    ms = train["step_ms"][True]
    print(f"[train-profile] bf16 step: device busy {busy:.4f} ms of "
          f"{ms:.4f} ms per step (idle share {1 - busy / ms:.3f}), "
          f"{kernels:.0f} kernels per step")
    for kname, (us, launches) in _port_kernels(by_name).items():
        in_step[kname] = us / launches / 1e3
        print(f"[train-profile]   {kname}: {us / launches:.2f} us per "
              f"launch in the step, {launches / n:.0f} launches per step")
    _print_globals(by_name, n, "train-profile")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, cnt) in top:
        print(f"[train-profile]   {us / n:9.2f} us/step  {cnt / n:5.0f}x  "
              f"{name[:90]}")
    return in_step


def phase_train_kernel_times(g, launches: dict, errs: dict,
                             in_step: dict) -> list:
    """Phase 10: the backward kernels' main-path variants at the bench
    shapes (bf16 pair segment sum; stats backward with the affine)."""
    N, E, D, K = g.num_nodes, g.senders.shape[0], WIDTH, g.max_deg
    e_real = int(g.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(3)
    ct = torch.randn(E, D, generator=gen, device="cuda").bfloat16()
    # the flagship's backward: no sum section, so no d_sum
    x, aff, res, cts = _stats_bwd_inputs(g.csr_row_ptr, K, E, D, gen,
                                         ("d_sum",))
    bwd_args = (x, g.csr_row_ptr, K, *res, *cts.values(), aff)
    # the nearest PyTorch call for the pair sum: two float32 index_add_
    # (one per half) on float32 rows, ids prepared outside the timing
    ctf = ct.float()
    recv = g.receivers.long().clamp(max=N)
    send = g.senders.long().clamp(max=N)
    acc = torch.zeros(N + 1, D, device="cuda")

    def library_pair():
        acc.zero_().index_add_(0, recv, ctf)
        acc.zero_().index_add_(0, send, ctf)

    cases = {
        # the real ct rows, two row-pointer arrays, csc_perm, 2 outputs;
        # one add per real element and half
        "pair_segment_sum": (
            lambda: pair_segment_sum(ct, g.csr_row_ptr, g.csc_row_ptr,
                                     g.csc_perm),
            lambda: pair_segment_sum_reference(ct, g.csr_row_ptr,
                                               g.csc_row_ptr, g.csc_perm),
            e_real * D * 2 + 2 * (N + 1) * 4 + e_real * 4 + 2 * N * D * 2,
            2.0 * e_real * D, "bf16", library_pair,
            "two float32 index_add_ calls, one per half"),
        # each byte once: the real x rows, the d_x rows (padding
        # included), seven [N, D] node arrays (mean, std, enc, d_mean,
        # d_std, d_max, d_min), row_ptr, the affine in and its cotangents
        # out; per edge element ~20 flops (affine, d, routing, column sums)
        "pna_stats_bwd": (
            lambda: pna_stats_bwd(*bwd_args),
            lambda: pna_stats_bwd_reference(*bwd_args),
            e_real * D * 2 + E * D * 2 + 7 * N * D * 2 + (N + 1) * 4
            + 2 * D * 4 + 2 * D * 4,
            20.0 * e_real * D, "bf16, affine, no d_sum", None,
            "no PyTorch call computes the extremum routing by winner slot "
            "with the affine's column sums"),
    }
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for name, (kern, plain, nbytes, flops, variant, lib, lib_note) in \
            cases.items():
        warm = device_ms(kern, iters=100, warmup=10)
        ms = device_ms(kern, iters=20, flush=flush)
        plain_ms = device_ms(plain, iters=10)
        lib_ms = device_ms(lib, iters=100, warmup=10) if lib else None
        bound_ms, bound_by = _bound(nbytes, flops)
        src, replaces = KERNEL_INFO[name]
        step_us = in_step.get(name)
        print(f"[times] {name} ({variant}; __global__ "
              f"{PROFILE_NAMES[name][0]}): device {ms:.5f} ms cold-L2 "
              f"median, {warm:.5f} ms warm, "
              f"{'not measured' if step_us is None else f'{step_us:.5f} ms'}"
              f" in the step; plain {plain_ms:.5f} ms; library "
              f"{'null' if lib_ms is None else f'{lib_ms:.5f} ms'} "
              f"({lib_note}); bound {bound_ms:.5f} ms by {bound_by} "
              f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP f32)")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    # what the in-kernel column sums cost: the same launch without the
    # affine (no tile partials, counters or chunk sums), warm
    bare = device_ms(lambda: pna_stats_bwd(*bwd_args[:-1], None), iters=100,
                     warmup=10)
    with_sums = device_ms(lambda: pna_stats_bwd(*bwd_args), iters=100,
                          warmup=10)
    print(f"[times] pna_stats_bwd warm with the affine {with_sums:.5f} ms, "
          f"without it {bare:.5f} ms: the column sums cost "
          f"{with_sums - bare:.5f} ms")
    return rows


# --- the GIN slice: phases 11 to 13 -----------------------------------------

def gin_batch(device="cuda"):
    """The GIN slice's labelled batch (128 molhiv-like molecules, seed 0)
    and its sizes."""
    return labelled_batch(GIN_BATCH, GIN_MODEL_PARAMETERS["target_dim"],
                          device=device, **GIN_DATA)


def _vec_elems(dtype: torch.dtype, D: int) -> int:
    """Elements per thread of a walk over rows of D elements (`vec_width`
    in csrc/common.cuh, for 16-byte aligned tensors)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    row = D * elem
    return 16 // elem if row % 16 == 0 else 8 // elem if row % 8 == 0 else 1


def _vector_path(dtype: torch.dtype, D: int) -> str:
    """Which vector path the GIN kernels take for rows of D elements
    (`vec_width` in csrc/common.cuh; the wrappers' tensors are 16-byte
    aligned)."""
    row = D * (2 if dtype == torch.bfloat16 else 4)
    return ("16-byte" if row % 16 == 0 else "8-byte" if row % 8 == 0
            else "element-wise")


def _sum_path(dtype: torch.dtype, D: int, N: int, E: int,
              aligned: bool = True) -> str:
    """The path csr_sum's launcher picks (`stream_path` in
    csrc/csr_sum.cu): the stream, each tile's rows staged in shared
    memory, where E >= 8 N and a node's column vectors fit one block of
    128 threads; else the walk; with its vector (element-wise where the
    messages are not 16-byte aligned)."""
    vec = _vec_elems(dtype, D) if aligned else 1
    stream = E >= 8 * N and D // vec <= 128
    return (f"{'stream' if stream else 'walk'}, "
            f"{_vector_path(dtype, D) if aligned else 'element-wise'}")


def _hold_csr_sum(phase: str, gen, g, widths) -> list:
    """Row 7 (`csr_sum`) against its plain version on `g`'s edges at each
    width, bf16 and float32, on every path its launcher picks
    (`_sum_path`): the public wrapper; the raw launch with 64-bit indices
    forced; and the real rows shifted by one element (not 16-byte aligned:
    element-wise vectors, and on the stream the tensor's partial first and
    last words moved element by element) over the first N - 1 nodes, the
    last of which, a padding node, ends at the tensor's end.  All sum the
    same float32 terms in slot order -> bit-exact.  Padding edges,
    their rows set to 1e4, must not count (a sum of at most 69 standard
    normals stays far below one such row); nodes without edges get 0.
    Returns the (kernel, plain) pairs."""
    mod = importlib.import_module("infomax3d_tpu_torch.ops.kernels.csr_sum")
    N, E = g.num_nodes, g.senders.shape[0]
    rp = g.csr_row_ptr
    e_real = int(rp[-1])
    empty = (rp[1:] - rp[:-1]) == 0
    _check(bool(empty[-1]) and e_real < E,
           f"csr_sum {phase}: padding nodes and padding edges")
    pairs = []
    for D in widths:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(E, D, generator=gen, device="cuda").to(dt)
            x[e_real:] = 1e4
            xs = _shifted(x[:e_real + 1])
            runs = (("public wrapper", csr_sum, (x, rp),
                     _sum_path(dt, D, N, E)),
                    ("64-bit indices",
                     lambda *a: mod._launch(*a, wide=True), (x, rp),
                     _sum_path(dt, D, N, E)),
                    ("real rows shifted by one element", csr_sum,
                     (xs, rp[:-1]),
                     _sum_path(dt, D, N - 1, e_real, aligned=False)))
            for run, fn, args, path in runs:
                k = fn(*args)
                ref = csr_sum_reference(*args)
                torch.cuda.synchronize()
                tag = f"csr_sum {phase} D={D} {dt} {run} ({path})"
                _check(k.dtype == torch.float32 and torch.equal(k, ref),
                       f"{tag}: not bit-exact")
                pairs.append((k, ref))
                if run != "real rows shifted by one element":
                    _check(bool((k[empty] == 0).all()),
                           f"{tag}: nonzero on nodes without edges")
                    _check(float(k.abs().max()) < 1e3,
                           f"{tag}: a padding row counted")
            print(f"[{phase}] csr_sum D={D} {dt}: bit-exact through "
                  + ", ".join(f"{run} ({path})" for run, _, _, path in runs)
                  + "; padding edges ignored, degree 0 gives 0")
    return pairs


def phase_gin_kernels(g) -> dict:
    """Phase 11: the CSR sum and the sender-keyed segment sum against their
    plain versions on the same CUDA tensors, at the slice's width (300: the
    8-byte path in bf16, 16-byte in float32) and at 302 (element-wise in
    bf16, 8-byte in float32).  The CSR sum (`_hold_csr_sum`: its walk at
    this batch's in-degree) sums the same rows in float32 in slot order ->
    bit-exact; the segment sum and the multi-reduce (on the same batch)
    are held by `_hold_walks`."""
    N, E = g.num_nodes, g.senders.shape[0]
    print(f"[gin-kernels] N={N} E={E} (real {int(g.csr_row_ptr[-1])}) "
          f"max in-degree {g.max_deg}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    widths = (GIN_WIDTH, GIN_WIDTH + 2)
    errs = {"csr_sum": _max_err(_hold_csr_sum("gin-kernels", gen, g,
                                              widths))}
    print(f"[gin-kernels] csr_sum: agrees with its plain version (max "
          f"|kernel - plain| = {errs['csr_sum']:.3g})")
    errs.update(_hold_walks(
        "gin-kernels", gen,
        [("GIN batch", g.csr_row_ptr, g.max_deg, E, widths)],
        [("GIN batch", g.csc_row_ptr, g.csc_perm, E, widths)]))
    return errs


def _gin_args(bf16: bool) -> dict:
    return {"model_type": GIN_MODEL_TYPE,
            "model_parameters": GIN_MODEL_PARAMETERS, "loss_func": GIN_LOSS,
            "optimizer_params": GIN_OPTIMIZER_PARAMS, "batch_size": GIN_BATCH,
            "bf16_compute": bf16, "seed": 0, "dataset_params": GIN_DATA}


def _gin_one_step(bf16: bool, dev: str, g):
    """`_measure_step` of one GIN step from the seeded weights."""
    step = build_supervised_step(_gin_args(bf16), torch.device(dev))
    return _measure_step(step, {"model": step.model}, (step.prepare(g),))


def _zeroed_gather_backward():
    """The GIN step check's planted fault: the sender gather's backward
    returns zeros.  Returns the undo."""
    mod = importlib.import_module("infomax3d_tpu_torch.ops.segment")
    real = mod.snd_segment_sum
    mod.snd_segment_sum = lambda ct, crp, perm: torch.zeros(
        crp.shape[0] - 1, ct.shape[1], dtype=ct.dtype, device=ct.device)
    return lambda: setattr(mod, "snd_segment_sum", real)


def phase_gin_train(smi: str) -> dict:
    """Phase 12: the GIN training main path and its checks.  Returns the
    main-path launches, the step times, the batch and its sizes."""
    _reset_counts()
    sizes = None
    for bf16 in (True, False):
        before = _counts()
        out = supervised(_gin_args(bf16), steps=TRAIN_STEPS)   # on the card
        after = _counts()
        per_step = {n: (after[n] - before[n]) / TRAIN_STEPS for n in after}
        _check(per_step == EXPECTED_GIN_STEP,
               f"launches per step {per_step} != {EXPECTED_GIN_STEP}")
        losses = out["losses"]
        _check(all(np.isfinite(losses)), f"non-finite losses {losses}")
        _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        print(f"[gin] bf16={bf16}: {TRAIN_STEPS} steps through supervised(), "
              f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; launches per step "
              f"{per_step}")
        sizes = out["sizes"]
    launches = _counts()
    print(f"[gin] GIN training main-path launches: {launches}")

    # one step on the card and on the CPU from the same weights and batch,
    # held as the pre-training step is (STEP_TOL, the zero-gradient floor,
    # the bf16 limits from the CPU's own bf16 step)
    g, _ = gin_batch("cpu")
    _hold_step_against_cpu(
        lambda bf16, dev: _gin_one_step(bf16, dev, g),
        ("model",), {"zeroed gather backward": _zeroed_gather_backward},
        "gin")

    step_ms, steps = {}, {}
    for bf16 in (True, False):
        step = build_supervised_step(_gin_args(bf16), torch.device("cuda"))
        gp = step.prepare(g)
        t = cuda_ms(lambda: step.step(gp), iters=20)
        step_ms[bf16], steps[bf16] = t, (step, gp)
        print(f"[gin] step bf16={bf16}: {t:.4f} ms, "
              f"{GIN_BATCH / t * 1e3:.1f} graphs/s ({sizes['nodes']} nodes, "
              f"{sizes['edges']} edges per step; CUDA events over 20 warm "
              f"steps; {smi})")
    return {"launches": launches, "step_ms": step_ms, "steps": steps,
            "batch": g.to("cuda")}


def phase_gin_profile(gin: dict, n: int = 5) -> dict:
    """Phase 13a: torch.profiler's CUDA kernel records over `n` warm GIN
    steps in bf16 and float32 -> device-busy ms per step, the idle share
    of the CUDA-event step time, kernels per step, the GIN kernels.
    Returns each GIN kernel's in-step us per launch (bf16 step)."""
    from torch.profiler import ProfilerActivity, profile
    in_step = {}
    for bf16 in (True, False):
        step, gp = gin["steps"][bf16]
        for _ in range(3):
            step.step(gp)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step.step(gp)
            torch.cuda.synchronize()
        by_name = _profile_kernels(prof)
        if not by_name:
            print(f"[gin-profile] bf16={bf16}: the profiler recorded no "
                  f"device activity; not measured")
            continue
        busy = sum(us for us, _ in by_name.values()) / n / 1e3
        kernels = sum(c for _, c in by_name.values()) / n
        ms = gin["step_ms"][bf16]
        print(f"[gin-profile] bf16={bf16} step: device busy {busy:.4f} ms of "
              f"{ms:.4f} ms per step (idle share {1 - busy / ms:.3f}), "
              f"{kernels:.0f} kernels per step")
        for kname, (us, launches) in _port_kernels(by_name).items():
            if bf16:
                in_step[kname] = us / launches / 1e3
            print(f"[gin-profile]   {kname}: {us / launches:.2f} us per "
                  f"launch in the step, {launches / n:.0f} launches per step")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        for name, (us, cnt) in top:
            print(f"[gin-profile]   {us / n:9.2f} us/step  {cnt / n:5.0f}x  "
                  f"{name[:90]}")
    return in_step


def phase_gin_kernel_times(g, launches: dict, errs: dict,
                           in_step: dict) -> list:
    """Phase 13b: the GIN kernels at the slice's shapes, in float32 (4 of
    each kernel's 5 launches per bf16 step, all 5 in float32) for the
    kernels line, and in bf16 (layer 0's launch of a bf16 step)."""
    N, E, D = g.num_nodes, g.senders.shape[0], GIN_WIDTH
    e_real = int(g.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(5)
    recv = g.receivers.long().clamp(max=N)
    send = g.senders.long().clamp(max=N)
    acc = torch.zeros(N + 1, D, device="cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for name in ("csr_sum", "snd_segment_sum"):
        row = None
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(E, D, generator=gen, device="cuda").to(dt)
            xf = x.float()
            esz = 2 if dt == torch.bfloat16 else 4
            if name == "csr_sum":
                # the real message rows, row_ptr, [N, D] float32 out
                kern = lambda: csr_sum(x, g.csr_row_ptr)  # noqa: E731
                plain = lambda: csr_sum_reference(  # noqa: E731
                    x, g.csr_row_ptr)
                ids = recv
                nbytes = e_real * D * esz + (N + 1) * 4 + N * D * 4
            else:
                # the real ct rows through csc_perm, csc_row_ptr, [N, D] of
                # ct's type out
                kern = lambda: snd_segment_sum(  # noqa: E731
                    x, g.csc_row_ptr, g.csc_perm)
                plain = lambda: snd_segment_sum_reference(  # noqa: E731
                    x, g.csc_row_ptr, g.csc_perm)
                ids = send
                nbytes = (e_real * D * esz + e_real * 4 + (N + 1) * 4
                          + N * D * esz)
            warm = device_ms(kern, iters=100, warmup=10)
            ms = device_ms(kern, iters=20, flush=flush)
            plain_ms = device_ms(plain, iters=10)
            # the nearest PyTorch call: one float32 index_add_ of the rows
            # by receiver (csr_sum) or sender (snd_segment_sum)
            lib_ms = device_ms(lambda: acc.zero_().index_add_(0, ids, xf),
                               iters=100, warmup=10)
            bound_ms, bound_by = _bound(nbytes, float(e_real * D))
            step_us = in_step.get(name)
            print(f"[times] {name} ({dt}, D={D}, {_vector_path(dt, D)} path):"
                  f" device {ms:.5f} ms cold-L2 median, {warm:.5f} ms warm, "
                  f"{'not measured' if step_us is None else f'{step_us:.5f} ms'}"
                  f" in the bf16 step (mean of its launches); plain "
                  f"{plain_ms:.5f} ms; library {lib_ms:.5f} ms (float32 "
                  f"index_add_); bound {bound_ms:.5f} ms by {bound_by} "
                  f"({nbytes / 1e6:.2f} MB, {e_real * D / 1e6:.1f} MFLOP f32)")
            src, replaces = KERNEL_INFO[name]
            row = {"name": name, "route": "cuda", "source": src,
                   "replaces": replaces, "launches": launches[name],
                   "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": lib_ms}
        rows.append(row)      # the float32 variant
    return rows


# --- the OT slice: phases 14 to 16 ------------------------------------------

def ot_slice_batch(device="cuda"):
    """The OT slice's batch (16 QM9-like molecules with 10 conformers,
    seed 0) and its sizes."""
    return ot_batch(OT_BATCH, OT_MODEL_PARAMETERS["hyperparams"][
        "n_true_confs"], device=device, **OT_DATA)


def phase_ot_kernels(ob, g) -> dict:
    """Phase 14: the OT step's three kernels against their plain versions
    on the same CUDA tensors (`_hold_walks`): the CSR segment sum (row 3)
    at the OT batch `ob` at D = 50 (element-wise in bf16, 8-byte in
    float32), 300 (8-byte bf16, 16-byte float32) and 302 (element-wise
    bf16, 8-byte float32), at the bench batch `g` (D = 200: 16-byte) and
    on a batch with in-degree-16 nodes (D = 50 and 200); the multi-reduce
    and the sender-keyed segment sum (rows 1 and 4) on the OT batch at
    D = 50, 300 and 302."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    gr, widths = ob.graph, (OT_WIDTH, 300, 302)
    E = gr.senders.shape[0]
    for name, b in (("OT batch", gr), ("bench batch", g)):
        print(f"[ot-kernels] {name}: N={b.num_nodes} E={b.senders.shape[0]} "
              f"(real {int(b.csr_row_ptr[-1])}) max in-degree {b.max_deg}")
    rp16, e16 = degree16_csr()
    return _hold_walks(
        "ot-kernels", gen,
        [("OT batch", gr.csr_row_ptr, gr.max_deg, E, widths)],
        [("OT batch", gr.csc_row_ptr, gr.csc_perm, E, widths)],
        [("OT batch", gr.csr_row_ptr, E, widths),
         ("bench batch", g.csr_row_ptr, g.senders.shape[0], (WIDTH,)),
         ("degree-16 batch", rp16, e16, (OT_WIDTH, WIDTH))])


def _ot_args() -> dict:
    return {"model_parameters": OT_MODEL_PARAMETERS,
            "optimizer_params": OT_OPTIMIZER_PARAMS, "batch_size": OT_BATCH,
            "seed": 0, "dataset_params": OT_DATA}


def _ot_one_step(dev: str, draws: list, plans=None, perturb: float = 0.0):
    """One OT step's passes from the seeded weights on `dev` with the
    given draws: (cost on the CPU, plans, `_measure_step` of the gradient
    pass: the loss and every clipped gradient).  Without `plans`, the
    step's own plans of its cost.  `perturb` scales the weights after the
    cost pass, as `_measure_step` does."""
    step = build_ot_step(_ot_args(), torch.device(dev))
    batch, _ = ot_slice_batch(dev)
    on_dev = [(k, t.to(dev)) for k, t in draws]
    cost = step.cost(batch, ReplayNoise(on_dev))
    if plans is None:
        plans = step.plans(cost, batch).cpu()
    return cost.cpu(), plans, _measure_step(
        step, {"model": step.model},
        (batch, ReplayNoise(on_dev), plans.to(dev)), perturb)


# The OT step on the card against the same step on the CPU, float32, with
# the same draws and plans: both run the port and differ in summation
# order.  The torsion head magnifies float32 rounding: `c_mlp`'s
# coefficients reach the loss through each pair's 2x2 inverse, divided by
# its determinant, and the min / max over permutations switch under it (the
# CPU port against the JAX package at the test size: worst leaf 6.4e-4, L2
# 1.4e-6, tests/test_torch_port_ot.py; the card against the CPU at full
# size: 1.2e-2 in c_mlp.Dense_0.weight, L2 1.7e-5, the same 1.2e-2 in the
# float32 witness below, and no leaf the witness bounds above 1.12x its
# witness; NVIDIA H100 80GB HBM3, 700.00 W).  So each leaf is held to
# OT_WITNESS_FACTOR times the witness, the CPU step's own move under
# weights perturbed by 2**-20 relative (8 float32 ulps), or OT_TOL["leaf"]
# where that is larger; the loss, the cost and the gradient's L2 to
# OT_TOL.  The model has neither zero-gradient leaves nor running
# statistics ("zero", "stats").  Two planted faults must fail the check:
# a zeroed receiver-gather backward (every backbone leaf) and the torsion
# head's gradient alone scaled by 1 + OT_HEAD_FAULT (it read 6.25e-2
# against c_mlp's bounds of 4.7e-2, 3.4e-2, 1e-3, 1e-3, and L2 2.2e-4).
OT_TOL = {"cost": 1e-5, "loss": 1e-5, "leaf": 1e-3, "l2": 1e-4, "zero": 0.0,
          "stats": 0.0}
OT_WITNESS_REL = 2.0 ** -20
OT_WITNESS_FACTOR = 4.0
OT_HEAD_FAULT = 1.0 / 16
OT_HEAD = ("model.c_mlp.", "model.alpha_mlp.")


def _ot_violations(one: tuple, ref: tuple, leaf_tol: dict):
    """An `_ot_one_step` result against the CPU's `ref`: (the cost's and
    loss's relative errors, `_readings` of the gradients, what breaks the
    check)."""
    (cost, _, (loss, grads)), (rcost, _, (rloss, rgrads)) = one, ref
    real = rcost < 1e8
    c = {"cost": float((cost - rcost)[real].abs().max()
                       / rcost[real].abs().max()),
         "loss": abs(loss - rloss) / abs(rloss)}
    r = _readings(grads, rgrads, ("model",), zero_leaves=())
    bad = [] if torch.equal(cost >= 1e8, ~real) else [
        "masked cost entries differ"]
    bad += [f"{k} {c[k]:.3g}" for k in c if c[k] > OT_TOL[k]]
    return c, r, bad + _violations(r, OT_TOL, {"model": OT_TOL["l2"]},
                                   leaf_tol)


def _print_ot_leaves(tag: str, r: dict, leaf_tol: dict):
    """The leaf nearest its bound and the torsion head's leaves."""
    leaves = r["model"]["leaves"]
    k = max(leaves, key=lambda k: leaves[k] / leaf_tol[k])
    head = ", ".join(f"{n[6:]} {e:.3g} of {leaf_tol[n]:.3g}"
                     for n, e in leaves.items() if n.startswith(OT_HEAD))
    print(f"[ot] {tag}: nearest its bound {leaves[k]:.3g} of "
          f"{leaf_tol[k]:.3g} ({k}); the torsion head: {head}")


def _zeroed_receiver_gather_backward():
    """The OT step check's first planted fault: the receiver gather's
    backward returns zeros.  Returns the undo."""
    mod = importlib.import_module("infomax3d_tpu_torch.ops.segment")
    real = mod.csr_segment_sum
    mod.csr_segment_sum = lambda ct, rp: torch.zeros(
        rp.shape[0] - 1, ct.shape[1], dtype=ct.dtype, device=ct.device)
    return lambda: setattr(mod, "csr_segment_sum", real)


def _skewed_torsion_head():
    """The OT step check's second planted fault, confined to the torsion
    head: the clipped gradient of `c_mlp` is scaled by 1 + OT_HEAD_FAULT.
    Returns the undo."""
    real = OTStep.loss_and_grads

    def skewed(self, *args):
        loss = real(self, *args)
        for p in self.model.c_mlp.parameters():
            p.grad.mul_(1 + OT_HEAD_FAULT)
        return loss
    OTStep.loss_and_grads = skewed
    return lambda: setattr(OTStep, "loss_and_grads", real)


class _HostNoise(GeneratorNoise):
    """Noise drawn on the host and copied to the card one draw at a time,
    each copy waiting for the stream; phase 15 times the step with it
    against the step drawing on the card, to show what host draws cost."""

    def _draw(self, kind: str, shape) -> torch.Tensor:
        t = super()._draw(kind, shape).to("cuda")
        self.draws[-1] = (kind, t)
        return t


def phase_ot_train(smi: str) -> dict:
    """Phase 15: the OT training main path and its checks.  Returns the
    main-path launches, the step and batch, the step times and sizes."""
    _reset_counts()
    out = ot(_ot_args(), steps=TRAIN_STEPS)                     # on the card
    launches = _counts()
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    _check(per_step == EXPECTED_OT_STEP,
           f"launches per step {per_step} != {EXPECTED_OT_STEP}")
    losses = out["losses"]
    _check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    print(f"[ot] {TRAIN_STEPS} float32 steps through ot(), loss "
          f"{' '.join(f'{x:.4f}' for x in losses)}; launches per step "
          f"{per_step}")
    print(f"[ot] OT training main-path launches: {launches}")

    # one step on the card and on the CPU: the same draws, the CPU's plans
    batch_cpu, _ = ot_slice_batch("cpu")
    noise = GeneratorNoise(torch.Generator().manual_seed(99))
    build_ot_step(_ot_args(), torch.device("cpu")).cost(batch_cpu, noise)
    ref = _ot_one_step("cpu", noise.draws)
    plans = ref[1]
    card = _ot_one_step("cuda", noise.draws, plans)
    own = _ot_one_step("cuda", noise.draws)[1]
    print(f"[ot] card plans from the card's own cost vs the CPU's: max "
          f"|diff| {float((own - plans).abs().max()):.3g}")
    witness = _readings(_ot_one_step("cpu", noise.draws, plans,
                                     OT_WITNESS_REL)[2][1], ref[2][1],
                        ("model",), zero_leaves=())
    leaf_tol = {k: max(OT_TOL["leaf"], OT_WITNESS_FACTOR * e)
                for k, e in witness["model"]["leaves"].items()}
    _print_readings(f"float32 witness (CPU, weights x (1 + "
                    f"{OT_WITNESS_REL:g} U(-1, 1)) vs CPU)", witness,
                    {"model": float("inf")}, "ot")
    c, r, bad = _ot_violations(card, ref, leaf_tol)
    print(f"[ot] card vs CPU: loss {card[2][0]:.6f} vs {ref[2][0]:.6f} "
          f"({c['loss']:.3g}), cost {c['cost']:.3g} (tol {OT_TOL})")
    _print_readings("card vs CPU", r, {"model": OT_TOL["l2"]}, "ot")
    _print_ot_leaves("card vs CPU", r, leaf_tol)
    w = witness["model"]["leaves"]
    ratio = max((e / w[k] for k, e in r["model"]["leaves"].items()
                 if OT_WITNESS_FACTOR * w[k] > OT_TOL["leaf"]), default=0.0)
    print(f"[ot] card vs CPU: largest leaf error over its witness, among "
          f"the leaves the witness bounds, {ratio:.3g} (factor "
          f"{OT_WITNESS_FACTOR:g})")
    _check(not bad, f"OT step card vs CPU: {bad}")
    for fault, plant in (
            ("zeroed receiver-gather backward",
             _zeroed_receiver_gather_backward),
            (f"c_mlp gradient x (1 + {OT_HEAD_FAULT:g})",
             _skewed_torsion_head)):
        undo = plant()
        try:
            planted = _ot_one_step("cuda", noise.draws, plans)
        finally:
            undo()
        _, rp, bad = _ot_violations(planted, ref, leaf_tol)
        _print_readings(f"planted fault ({fault}) card vs CPU", rp,
                        {"model": OT_TOL["l2"]}, "ot")
        _print_ot_leaves(f"planted fault ({fault})", rp, leaf_tol)
        print(f"[ot] planted fault ({fault}): {len(bad)} violations, e.g. "
              f"{bad[:3]}")
        _check(bool(bad), f"the OT step check passed a planted fault "
                          f"({fault})")

    # warm steps: each part timed on the host clock around synchronized
    # work, then whole steps back to back with CUDA events
    step, batch = out["step"], out["batch"]
    parts = {"cost pass": 0.0, "host EMD": 0.0, "gradient pass + update": 0.0}
    n = 10
    for i in range(n + 2):
        noise = GeneratorNoise(torch.Generator("cuda").manual_seed(1000 + i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost = step.cost(batch, noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plans = step.plans(cost, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step.loss_and_grads(batch, ReplayNoise(noise.draws), plans)
        step.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i >= 2:
            for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[key] += dt * 1e3 / n
    seeds = iter(range(2000, 3000))
    step_ms = cuda_ms(lambda: step.step(
        batch, torch.Generator("cuda").manual_seed(next(seeds))), iters=10)
    sizes = out["sizes"]
    print(f"[ot] step: {step_ms:.4f} ms, {OT_BATCH / step_ms * 1e3:.2f} "
          f"graphs/s (CUDA events over 10 warm steps); parts (host clock, "
          f"mean of {n}): " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in parts.items())
          + f"; batch {sizes}; {smi}")

    # what the host's draws cost: whole steps with the noise drawn on the
    # card against steps whose noise is drawn on the host and copied, in
    # alternating blocks of 4
    mod = importlib.import_module("infomax3d_tpu_torch.train.ot")
    times = {"card": [], "host": []}
    for _ in range(3):
        for where in times:
            if where == "host":
                mod.GeneratorNoise = _HostNoise
            try:
                times[where].append(cuda_ms(lambda: step.step(
                    batch, torch.Generator(
                        "cuda" if where == "card" else "cpu").manual_seed(
                            next(seeds))), iters=4, warmup=1))
            finally:
                mod.GeneratorNoise = GeneratorNoise
    card_ms, host_ms = (float(np.mean(v)) for v in times.values())
    print(f"[ot] noise drawn on the card {card_ms:.4f} ms per step, on the "
          f"host with {2 * 2 * OT_CONFS + 2} copies {host_ms:.4f} ms "
          f"(difference {host_ms - card_ms:.4f} ms; CUDA events, 3 "
          f"alternating blocks of 4 warm steps each: card "
          f"{', '.join(f'{t:.4f}' for t in times['card'])}, host "
          f"{', '.join(f'{t:.4f}' for t in times['host'])})")
    return {"launches": launches, "step": step, "batch": batch,
            "step_ms": step_ms, "parts": parts}


def phase_ot_profile(ot_run: dict, n: int = 3) -> dict:
    """Phase 16a: torch.profiler's CUDA kernel records over `n` warm OT
    steps -> device-busy ms per step, the idle share of the CUDA-event
    step time, kernels per step, the port's kernels and the top kernels.
    Returns each port kernel's in-step ms per launch."""
    from torch.profiler import ProfilerActivity, profile
    step, batch = ot_run["step"], ot_run["batch"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step.step(batch, torch.Generator("cuda").manual_seed(3000 + i))
        torch.cuda.synchronize()
    by_name = _profile_kernels(prof)
    in_step = {}
    if not by_name:
        print("[ot-profile] the profiler recorded no device activity; not "
              "measured")
        return in_step
    busy = sum(us for us, _ in by_name.values()) / n / 1e3
    kernels = sum(c for _, c in by_name.values()) / n
    ms = ot_run["step_ms"]
    print(f"[ot-profile] step: device busy {busy:.4f} ms of {ms:.4f} ms per "
          f"step (idle share {1 - busy / ms:.3f}), {kernels:.0f} kernels per "
          f"step")
    for kname, (us, launches) in _port_kernels(by_name).items():
        in_step[kname] = us / launches / 1e3
        print(f"[ot-profile]   {kname}: {us / launches:.2f} us per launch in "
              f"the step, {launches / n:.0f} launches per step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, cnt) in top:
        print(f"[ot-profile]   {us / n:9.2f} us/step  {cnt / n:5.0f}x  "
              f"{name[:90]}")
    return in_step


def phase_ot_kernel_times(ob, launches: dict, errs: dict,
                          in_step: dict) -> list:
    """Phase 16b: the CSR segment sum at the OT batch's shapes (D = 50), in
    float32 (the step's variant, in the kernels line) and in bf16."""
    gr = ob.graph
    rp = gr.csr_row_ptr
    N, E, D = gr.num_nodes, gr.senders.shape[0], OT_WIDTH
    e_real = int(rp[-1])
    gen = torch.Generator(device="cuda").manual_seed(7)
    recv = gr.receivers.long().clamp(max=N)
    acc = torch.zeros(N + 1, D, device="cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    row = None
    for dt in (torch.bfloat16, torch.float32):
        ct = torch.randn(E, D, generator=gen, device="cuda").to(dt)
        ctf = ct.float()
        esz = 2 if dt == torch.bfloat16 else 4
        # the real ct rows, row_ptr, [N, D] of ct's type out; one add per
        # real element
        nbytes = e_real * D * esz + (N + 1) * 4 + N * D * esz
        warm = device_ms(lambda: csr_segment_sum(ct, rp), iters=100,
                         warmup=10)
        ms = device_ms(lambda: csr_segment_sum(ct, rp), iters=20,
                       flush=flush)
        plain_ms = device_ms(lambda: csr_segment_sum_reference(ct, rp),
                             iters=10)
        # the nearest PyTorch call: one float32 index_add_ by receiver
        lib_ms = device_ms(lambda: acc.zero_().index_add_(0, recv, ctf),
                           iters=100, warmup=10)
        bound_ms, bound_by = _bound(nbytes, float(e_real * D))
        step_ms = in_step.get("csr_segment_sum")
        in_step_ms = ("not measured" if step_ms is None
                      else f"{step_ms:.5f} ms")
        print(f"[times] csr_segment_sum ({dt}, D={D}, {_vector_path(dt, D)} "
              f"path): device {ms:.5f} ms cold-L2 median, {warm:.5f} ms "
              f"warm, {in_step_ms} in the float32 step (mean of its launches); plain "
              f"{plain_ms:.5f} ms; library {lib_ms:.5f} ms (float32 "
              f"index_add_); bound {bound_ms:.5f} ms by {bound_by} "
              f"({nbytes / 1e6:.3f} MB, {e_real * D / 1e6:.3f} MFLOP f32)")
        if dt == torch.float32:
            _row3_against_index_add(
                lambda: csr_segment_sum(ct, rp),
                lambda: acc.zero_().index_add_(0, recv, ctf), flush)
        src, replaces = KERNEL_INFO["csr_segment_sum"]
        row = {"name": "csr_segment_sum", "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches["csr_segment_sum"],
               "max_abs_err": errs["csr_segment_sum"], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms}
    _ot_walk_times(ob, in_step, flush)
    return [row]      # the float32 variant


# interleaved repeats of row 3 against its library call (phase 16b)
ROW3_REPEATS = 6


def _row3_against_index_add(kern, lib, flush):
    """Row 3 (float32, the OT step's shape) and its `index_add_` (with the
    `zero_` of its accumulator, as in the kernels line) in alternating
    order over `ROW3_REPEATS` repeats, each cold-L2 (median of 20 calls)
    and warm (mean of 100): the spread of each, and the ratio of each
    repeat's pair."""
    times = {f"{who} {how}": [] for who in ("row 3", "index_add_")
             for how in ("cold", "warm")}
    for r in range(ROW3_REPEATS):
        pair = (("row 3", kern), ("index_add_", lib))
        for who, fn in (pair if r % 2 == 0 else pair[::-1]):
            times[f"{who} cold"].append(device_ms(fn, iters=20, flush=flush))
            times[f"{who} warm"].append(device_ms(fn, iters=100, warmup=10))
    for key, ts in times.items():
        print(f"[times] row 3 A/B, {key}: min {min(ts):.5f} median "
              f"{float(np.median(ts)):.5f} max {max(ts):.5f} ms over "
              f"{ROW3_REPEATS} interleaved repeats")
    for how in ("cold", "warm"):
        ratio = np.asarray(times[f"row 3 {how}"]) / np.asarray(
            times[f"index_add_ {how}"])
        print(f"[times] row 3 A/B, row 3 / index_add_ {how}: per repeat "
              f"{np.round(ratio, 4).tolist()}; row 3 faster in "
              f"{int((ratio < 1).sum())} of {ROW3_REPEATS}")


def _ot_walk_times(ob, in_step: dict, flush):
    """Rows 1 and 4 at the OT step's shapes (float32, D = 50, the step's
    variant; the kernels line keeps their larger main-path shapes, phases 6
    and 13): cold-L2, warm, in the step, plain, the library call for row 4
    (float32 `index_add_` by sender) and the byte bound."""
    gr = ob.graph
    N, E, D = gr.num_nodes, gr.senders.shape[0], OT_WIDTH
    e_real = int(gr.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(E, D, generator=gen, device="cuda")
    send = gr.senders.long().clamp(max=N)
    acc = torch.zeros(N + 1, D, device="cuda")
    K, rp, crp, perm = gr.max_deg, gr.csr_row_ptr, gr.csc_row_ptr, gr.csc_perm
    cases = {
        # the real rows, row_ptr, 4 float32 [N, D] sections out
        "multi_reduce": (lambda: multi_reduce(x, rp, K),
                         lambda: multi_reduce_reference(x, rp, K), None,
                         e_real * D * 4 + (N + 1) * 4 + 4 * N * D * 4),
        # the real rows through csc_perm, csc_row_ptr, one [N, D] out
        "snd_segment_sum": (
            lambda: snd_segment_sum(x, crp, perm),
            lambda: snd_segment_sum_reference(x, crp, perm),
            lambda: acc.zero_().index_add_(0, send, x),
            e_real * D * 4 + e_real * 4 + (N + 1) * 4 + N * D * 4)}
    for name, (kern, plain, lib, nbytes) in cases.items():
        warm = device_ms(kern, iters=100, warmup=10)
        ms = device_ms(kern, iters=20, flush=flush)
        plain_ms = device_ms(plain, iters=10)
        lib_ms = None if lib is None else device_ms(lib, iters=100,
                                                    warmup=10)
        bound_ms, bound_by = _bound(nbytes, 5.0 * e_real * D
                                    if name == "multi_reduce"
                                    else float(e_real * D))
        t = in_step.get(name)
        print(f"[times] {name} at the OT shape (float32, D={D}, "
              f"{_vector_path(torch.float32, D)} path): device "
              f"{ms:.5f} ms cold-L2 "
              f"median, {warm:.5f} ms warm, "
              + ("not measured" if t is None else f"{t:.5f} ms")
              + f" in the OT step (mean of its launches); plain "
              f"{plain_ms:.5f} ms; library "
              + ("null" if lib_ms is None else f"{lib_ms:.5f} ms (float32 "
                                               f"index_add_ by sender)")
              + f"; bound {bound_ms:.5f} ms by {bound_by} "
              f"({nbytes / 1e6:.3f} MB)")


# the block of rows 1, 3 and 4 (WALK_THREADS in csrc/common.cuh)
WALK_THREADS = 256


def _profiled_ms(fn, needle: str, n: int = 50):
    """Mean device ms of the kernels named like `needle` over `n`
    back-to-back calls of `fn`, in a profile; a profile that recorded none
    of them (it happens) is taken again, up to three times, then None."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rec = [v for k, v in _profile_kernels(prof).items() if needle in k]
        if rec:
            us, cnt = map(sum, zip(*rec))
            return us / cnt / 1e3
    return None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


def phase_launch_floor(ob, launches: dict, in_step: dict):
    """Phase 16c: the ladder of the OT step's small CSR walks, each rung's
    device time in a profile of back-to-back launches: the card's launch
    floor (an empty `__global__`) on the grid of rows 1, 3 and 4 at the OT
    shape, the index round trip on that grid (`index_probe_kernel`:
    row_ptr[n] and row_ptr[n + 1] loaded, one value stored per thread),
    and rows 1, 3 and 4 alone and in the step.  Beside them each row's
    byte bound at the OT batch's shapes (float32, D = 50) and its closable
    gap: launches x (in-step time - max(bound, floor)), per OT step and
    over the main paths' launches."""
    floor_fn = launcher("csr_sum", "launch_floor",
                        (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    probe_fn = launcher("csr_sum", "index_probe",
                        (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 3
                        + (ctypes.c_void_p,))
    stream = torch.cuda.current_stream().cuda_stream
    gr = ob.graph
    N, E, D = gr.num_nodes, gr.senders.shape[0], OT_WIDTH
    e_real = int(gr.csr_row_ptr[-1])
    x = torch.randn(E, D, generator=torch.Generator(device="cuda")
                    .manual_seed(9), device="cuda")
    nvec = D // _vec_elems(torch.float32, D)
    walk_grid = (-(-N * nvec // WALK_THREADS), WALK_THREADS)
    probe_out = torch.empty(N * nvec, device="cuda")

    def floor():
        _check(floor_fn(*walk_grid, stream) == 0,
               "launch_floor: launch failed")

    def probe():
        _check(probe_fn(gr.csr_row_ptr.data_ptr(), probe_out.data_ptr(), N,
                        nvec, WALK_THREADS, stream) == 0,
               "index_probe: launch failed")

    fl = _profiled_ms(floor, "launch_floor_kernel")
    probe()
    torch.cuda.synchronize()
    deg = (gr.csr_row_ptr[1:] - gr.csr_row_ptr[:-1]).float()
    _check(torch.equal(probe_out.view(N, nvec),
                       deg[:, None].expand(N, nvec)),
           "index_probe: wrong degrees")
    probe_ms = _profiled_ms(probe, "index_probe_kernel")
    alone = {"multi_reduce": _profiled_ms(
                 lambda: multi_reduce(x, gr.csr_row_ptr, gr.max_deg),
                 "multi_reduce_kernel"),
             "csr_segment_sum": _profiled_ms(
                 lambda: csr_segment_sum(x, gr.csr_row_ptr),
                 "csr_segment_sum_kernel"),
             "snd_segment_sum": _profiled_ms(
                 lambda: snd_segment_sum(x, gr.csc_row_ptr, gr.csc_perm),
                 "snd_segment_sum_kernel")}
    print(f"[floor] ladder on the walks' grid ({walk_grid[0]} blocks of "
          f"{walk_grid[1]}): floor {_fmt(fl)}; index "
          f"round trip (index_probe_kernel) {_fmt(probe_ms)}"
          + ("" if None in (fl, probe_ms)
             else f" (+{probe_ms - fl:.5f} over the floor)"))
    for name, ms in alone.items():
        t = in_step.get(name)
        print(f"[floor] ladder: {name} alone {_fmt(ms)}"
              + ("" if None in (ms, probe_ms)
                 else f" (+{ms - probe_ms:.5f} over the index round trip: "
                      f"its rows, adds and stores)")
              + f", in the OT step {_fmt(t)}"
              + ("" if None in (t, ms) else f" (+{t - ms:.5f} over alone)"))
    nbytes = {
        # the real rows, row_ptr, 4 float32 [N, D] sections out
        "multi_reduce": e_real * D * 4 + (N + 1) * 4 + 4 * N * D * 4,
        # the real rows, row_ptr, one [N, D] out
        "csr_segment_sum": e_real * D * 4 + (N + 1) * 4 + N * D * 4,
        # the real rows through csc_perm, csc_row_ptr, one [N, D] out
        "snd_segment_sum": (e_real * D * 4 + e_real * 4 + (N + 1) * 4
                            + N * D * 4)}
    for name, b in nbytes.items():
        bound = b / PEAK_BYTES_PER_S * 1e3
        t = in_step.get(name)
        per_step = EXPECTED_OT_STEP[name]
        over = None if None in (t, fl) else t - max(bound, fl)
        gap = "not measured" if over is None else (
            f"{per_step * over:.5f} ms per OT step ({per_step} launches), "
            f"{launches[name] * over:.5f} ms over the main paths' "
            f"{launches[name]} launches")
        print(f"[floor] {name} at the OT shape (N={N}, E real {e_real}, D={D},"
              f" float32, {walk_grid[0]} blocks of {walk_grid[1]}): bound "
              f"{bound:.5f} ms ({b / 1e6:.3f} MB), floor {_fmt(fl)}, in the "
              f"OT step {_fmt(t)}; closable gap {gap}")


# --- phase 17: the trainer CLI ---------------------------------------------

TRAINER_PRE = "configs_clean/pre-train_QM9.yml"
TRAINER_TUNE = "configs_clean/tune_QM9_homo.yml"
# Overrides of both configs: 5000 synthetic molecules (a model pool of
# 4000, validation 500, test 500); the pre-training takes 1000 of the pool
# (2 steps an epoch at batch 500), the fine-tune 1024 (8 steps at batch
# 128) and transfers from the pre-training's best checkpoint.
TRAINER_COMMON = {"dataset": "synthetic", "dataset_params": {"num": 5000},
                  "num_epochs": 2, "use_tensorboard": False}
TRAINER_RUNS = {
    "pre": (TRAINER_PRE, dict(TRAINER_COMMON, num_train=1000)),
    "tune": (TRAINER_TUNE, dict(TRAINER_COMMON, num_train=1024,
                                targets=["t0"], eval_on_test=True)),
}
# None: the CLI's default device, the card
TRAINER_DEVICE = None
# train steps and eval forwards of each run: 2 epochs of 2 (8) steps; a
# validation per epoch, the best checkpoint's and the test set's, each of
# 500 molecules: 1 batch of 500 (contrastive, full batches), 4 of 128
TRAINER_STEPS = {"pre": 4, "tune": 16, "pre_f32": 2}
TRAINER_EVALS = {"pre": 4, "tune": 16, "pre_f32": 3}
# The float32 pre-training of 1 epoch on the card against the same run on
# the CPU: the validation loss within phase 8's float32 loss bound (1e-5
# relative, STEP_TOL); the other probes within 1e-4 of max(|CPU|, 1), the
# threshold probes within one count of a batch of 500 (1/500).  The two
# steps barely move the weights (the warmup's lrs are 0 and 8e-5 / 700),
# so this holds the forward of a whole loop, its metrics and its batches.
F32_RUN_TOL = {"loss": STEP_TOL[False]["loss"], "probe": 1e-4,
               "count": 1 / 500}
THRESHOLD_PROBES = ("contrastive_accuracy", "true_negative_rate",
                    "true_positive_rate")


def _trainer_args(kind: str, logdir: Path, **extra) -> dict:
    from infomax3d_tpu_torch.cli.config import load_config
    config, overrides = TRAINER_RUNS[kind]
    return load_config(config, dict(overrides, logdir=str(logdir), **extra))


def _run_dir(logdir: Path) -> Path:
    dirs = sorted(p for p in logdir.iterdir() if p.is_dir())
    _check(len(dirs) == 1, f"{logdir}: run dirs {dirs}")
    return dirs[0]


def _val_records(run_dir: Path) -> list:
    recs = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    return [r for r in recs if r["split"] == "val"]


_NOT_METRICS = ("split", "step", "epoch", "time")


def _expected_run(bf16: bool, kind: str) -> dict:
    return _expect(EXPECTED_STEP[bf16], EXPECTED[bf16], TRAINER_STEPS[kind],
                   TRAINER_EVALS[kind])


def _data_run(config: str, overrides: dict, logdir: Path, device,
              unbounded: tuple = ()) -> dict:
    """`load_config` + `train` of `config` with `overrides`, as a user
    runs them; returns the result (every metric finite, but those named
    in `unbounded`, which may be infinite and not NaN), the run dir, the
    printed text, the launches, the wall seconds and the args."""
    import contextlib
    import io
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import train
    args = load_config(config, dict(overrides, logdir=str(logdir)))
    text = io.StringIO()
    before = _counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        result = train(args, device=device)
    wall = time.perf_counter() - t0
    after = _counts()
    _check(all(np.isfinite(v) or (k.endswith(unbounded) and not np.isnan(v))
               for k, v in result.items()),
           f"{config}: non-finite metrics {result}")
    return {"result": result, "dir": _run_dir(logdir), "args": args,
            "wall_s": wall, "text": text.getvalue(),
            "launches": {n: after[n] - before[n] for n in after}}


def _cli_run(kind: str, logdir: Path, device, **extra):
    """`_data_run` of `TRAINER_RUNS[kind]` with `extra` overrides, its
    text printed and its run files checked."""
    config, overrides = TRAINER_RUNS[kind]
    run = _data_run(config, dict(overrides, **extra), logdir, device)
    print(run["text"], end="")
    for name in ("best_checkpoint.pt", "last_checkpoint.pt",
                 "train_arguments.yaml", "metrics.jsonl",
                 "evaluation_val_best_checkpoint.txt", "timing.json"):
        _check((run["dir"] / name).exists(), f"{kind}: no {name}")
    return run


def _fresh_trainer(kind: str, logdir: Path, dataset, device):
    """A new trainer of run `kind` with weights from another seed, and
    its validation loader."""
    from infomax3d_tpu_torch.cli import train as cli
    from infomax3d_tpu_torch.losses import SUPERVISED_LOSSES, get_loss
    from infomax3d_tpu_torch.train.trainer import get_trainer_class
    args = _trainer_args(kind, logdir, seed=7)
    cli.seed_all(args["seed"])
    cli.resolve_collate(args)
    cli.apply_dataset_protocol(args, dataset)
    cli.resolve_fast_paths(args)
    name = "contrastive" if args.get("model3d_type") else "default"
    loss = args["loss_func"]
    tr = get_trainer_class(name)(
        cli.build_models(args, dataset), args,
        cli.build_metrics(args, dataset), args["main_metric"], str(logdir),
        None if loss in SUPERVISED_LOSSES else
        get_loss(loss, **(args.get("loss_params") or {})), loss,
        args["main_metric_goal"], args["scheduler_step_per_batch"],
        device=device, use_tensorboard=False)
    tr.init_state()
    return tr, cli.make_loaders(args, dataset)


def _best_epoch_metrics(run_dir: Path, goal_min: bool, key: str) -> dict:
    """The validation record of the best epoch (ties: the later, as the
    trainer's `<=` keeps it)."""
    best = None
    for r in _val_records(run_dir):
        if best is None or (r[key] <= best[key] if goal_min
                            else r[key] >= best[key]):
            best = r
    return {k: v for k, v in best.items() if k not in _NOT_METRICS}


def _reload_mismatches(want: dict, got: dict) -> list:
    return [(k, want[k], got.get(k)) for k in want if got.get(k) != want[k]]


def _no_running_stats_checkpoint():
    """The reload check's planted fault: checkpoints saved without the
    running statistics, loaded without complaint.  Returns the undo."""
    ck = importlib.import_module("infomax3d_tpu_torch.train.checkpoint")
    real_save, real_load = ck.state_dicts, ck.load_state_dicts

    def save(models, *args):
        return {k: {n: t for n, t in sd.items() if "running" not in n}
                for k, sd in real_save(models, *args).items()}

    def load(models, payload):
        for k, m in models.items():
            m.load_state_dict(payload[ck.STATE_DICT_KEYS[k]], strict=False)
    ck.state_dicts, ck.load_state_dicts = save, load

    def undo():
        ck.state_dicts, ck.load_state_dicts = real_save, real_load
    return undo


def _hold_reload(kind: str, run: dict, logdir: Path):
    """The best checkpoint reloaded gives the best epoch's validation
    metrics bit for bit: the trainer's own `val_best_checkpoint`
    evaluation, and a new trainer (weights from another seed) that loads
    `best_checkpoint.pt`.  The planted fault (a checkpoint saved without
    the running statistics) must fail the same check."""
    from infomax3d_tpu_torch.cli.train import build_dataset, resolve_collate
    args = run["args"]
    goal_min = args["main_metric_goal"] == "min"
    key = args["loss_func"] if args["main_metric"] == "loss" \
        else args["main_metric"]
    want = _best_epoch_metrics(run["dir"], goal_min, key)
    bad = _reload_mismatches(want, run["result"])
    _check(not bad, f"{kind}: val_best_checkpoint != best epoch: {bad}")
    a = dict(args)
    resolve_collate(a)
    dataset = build_dataset(a)
    tr, (_, val_loader, _) = _fresh_trainer(kind, logdir / "fresh", dataset,
                                            run["device"])
    tr._load(str(run["dir"] / "best_checkpoint.pt"), restore_host=False)
    bad = _reload_mismatches(want, tr.evaluate_epoch(val_loader))
    _check(not bad, f"{kind}: reloaded best checkpoint != best epoch: {bad}")
    undo = _no_running_stats_checkpoint()
    try:
        tr.save_checkpoint(0, "no_running_stats.pt")
        tr2, _ = _fresh_trainer(kind, logdir / "fault", dataset,
                                run["device"])
        tr2._load(str(logdir / "fresh" / "no_running_stats.pt"),
                  restore_host=False)
        caught = _reload_mismatches(want, tr2.evaluate_epoch(val_loader))
    finally:
        undo()
    _check(bool(caught), f"{kind}: the reload check passed a checkpoint "
           f"without running statistics")
    print(f"[trainer] {kind}: the best checkpoint (epoch of the best "
          f"{key}) reloaded gives its validation metrics bit for bit, in "
          f"the run and in a new trainer; planted fault (saved without "
          f"running statistics) caught: {len(caught)} of {len(want)} "
          f"metrics differ")


def _bare_step_ms(kind: str, args: dict, device) -> float:
    """Device ms of the bare step (`PretrainStep` / `SupervisedStep`) on
    the run's first train batch: CUDA events over warm steps."""
    from infomax3d_tpu_torch.cli import train as cli
    from infomax3d_tpu_torch.data.loader import to_device
    from infomax3d_tpu_torch.models.registry import build_model
    from infomax3d_tpu_torch.train.optim import build_adam
    from infomax3d_tpu_torch.train.supervised import SupervisedStep
    a = dict(args)
    cli.resolve_collate(a)
    dataset = cli.build_dataset(a)
    cli.resolve_fast_paths(a)
    batch = next(iter(cli.make_loaders(a, dataset)[0]))
    if kind == "pre":
        step = build_step(dict(_train_args(True), seed=0), device)
        b = step.prepare(to_device(batch["graph2d"], device),
                         to_device(batch["graph3d"], device))
    else:
        model = build_model("PNA", a["model_parameters"])
        step = SupervisedStep.from_modules(
            model, device, torch.bfloat16, a["loss_func"],
            build_adam(model.named_parameters(),
                       **a["optimizer_params"]))
        b = (step.prepare(to_device(batch["graph"], device)),)
    return cuda_ms(lambda: step.step(*b), iters=10)


def _print_loop(kind: str, run: dict, bare_ms, smi: str):
    t = json.load(open(run["dir"] / "timing.json"))
    steps = TRAINER_STEPS[kind]
    ms = np.asarray(t["step_ms"])
    epoch_ms = [round(x * 1e3, 3) for x in t["train_epoch_s"]]
    eval_ms = [round(x * 1e3, 3) for x in t["eval_s"]]
    print(f"[trainer] {kind} loop: wall {run['wall_s']:.3f} s for the run; "
          f"ms per epoch (training) {epoch_ms}, (validation) {eval_ms}; "
          f"{steps / sum(t['train_epoch_s']):.3f} steps/s in the loop "
          f"({steps} steps); {smi}")
    if ms.size:
        print(f"[trainer] {kind} step inside train_epoch (CUDA events, "
              f"{ms.size} steps): median {np.median(ms):.4f} ms, mean "
              f"{ms.mean():.4f} ms, first {ms[0]:.4f} ms; bare step at the "
              f"same batch {_fmt(bare_ms)}; {smi}")
    host = {k: round(t[k], 4) for k in ("loader", "to_device", "step",
                                         "device_wait", "metrics",
                                         "checkpoint", "logging")}
    print(f"[trainer] {kind} host seconds: {host} (loader = waiting on the "
          f"prefetch thread; step = the steps' host launches; device_wait = "
          f"synchronizing before metrics); {smi}")


def phase_trainer(smi: str, out_dir: Path) -> dict:
    """Phase 17: the trainer CLI's main path (bf16 pre-training, then the
    fine-tune from its best checkpoint), its checks and its loop timing.
    Returns the main path's launches."""
    import shutil
    from infomax3d_tpu_torch.models.registry import build_model
    root = out_dir / "trainer"
    shutil.rmtree(root, ignore_errors=True)
    device = torch.device("cuda" if TRAINER_DEVICE is None
                          else TRAINER_DEVICE)
    _reset_counts()
    pre = _cli_run("pre", root / "pre", TRAINER_DEVICE)
    tune = _cli_run("tune", root / "tune", TRAINER_DEVICE,
                    pretrain_checkpoint=str(pre["dir"] / "best_checkpoint.pt"))
    f32 = _cli_run("pre", root / "pre_f32", TRAINER_DEVICE, num_epochs=1,
                   bf16_compute=False)
    launches = _counts()
    for kind, run, bf16 in (("pre", pre, True), ("tune", tune, True),
                            ("pre_f32", f32, False)):
        want = (_expected_run(bf16, kind) if device.type == "cuda"
                else dict(NONE))
        _check(run["launches"] == want,
               f"{kind}: launches {run['launches']} != {want}")
        run["device"] = device
        print(f"[trainer] {kind}: result {run['result']}; launches "
              f"{run['launches']} ({TRAINER_STEPS[kind]} steps, "
              f"{TRAINER_EVALS[kind]} eval forwards)")
    print(f"[trainer] trainer main-path launches: {launches}")

    # the transfer: PNA 200x7's node_gnn tensors that are not BatchNorm's
    model = build_model("PNA", tune["args"]["model_parameters"])
    n_want = sum(1 for n, _ in model.named_parameters()
                 if n.startswith("node_gnn.") and "batch_norm" not in n)
    line = next(x for x in tune["text"].splitlines()
                if x.startswith("transferred "))
    _check(int(line.split()[1]) == n_want,
           f"transfer count {line} != {n_want}")
    print(f"[trainer] tune: {line.split(' from ')[0]} (node_gnn tensors "
          f"that are not BatchNorm's in PNA 200x7: {n_want})")
    _check((tune["dir"] / "evaluation_test.txt").exists(),
           "tune: no evaluation_test.txt")

    for kind, run in (("pre", pre), ("tune", tune)):
        _hold_reload(kind, run, root / f"{kind}_reload")

    # float32: the same 1-epoch pre-training on the CPU
    cpu = _cli_run("pre", root / "pre_f32_cpu", "cpu", num_epochs=1,
                   bf16_compute=False)
    _hold_f32_run("[trainer] float32 1-epoch pre-training, card vs CPU",
                  f32, cpu)

    for kind, run in (("pre", pre), ("tune", tune)):
        bare = _bare_step_ms(kind, run["args"], device) \
            if device.type == "cuda" else None
        _print_loop(kind, run, bare, smi)
    return {"launches": launches, "runs": {"pre": pre, "pre_f32": f32}}


def _hold_f32_run(tag: str, run: dict, ref: dict):
    """The first validation record of float32 `run` against `ref`'s under
    `F32_RUN_TOL`."""
    got, want = (_val_records(r["dir"])[0] for r in (run, ref))
    worst = {}
    for k, v in want.items():
        if k in _NOT_METRICS:
            continue
        d = abs(got[k] - v)
        if k == run["args"]["loss_func"]:
            tol = F32_RUN_TOL["loss"] * abs(v)
        elif k in THRESHOLD_PROBES:
            tol = F32_RUN_TOL["count"]
        else:
            tol = F32_RUN_TOL["probe"] * max(abs(v), 1.0)
        worst[k] = (d, tol)
    print(f"{tag} (|difference|, tolerance): {worst}")
    bad = {k: v for k, v in worst.items() if not v[0] <= v[1]}
    _check(not bad, f"{tag}: {bad}")


# --- phase 18: multi-conformer pre-training ---------------------------------

# configs_clean/pre-train_QMugs.yml and pre-train_GEOM-Drugs.yml: phase 8's
# architecture (MODEL_PARAMETERS, MODEL3D_PARAMETERS, LOSS_PARAMS,
# OPTIMIZER_PARAMS, BATCH) with the flat Net3D (`model3d_type: Net3D`,
# `conformer_collate`), the multi-positive loss and C conformers per
# molecule.  Their datasets (QMugs, GEOM-Drugs) are not in the repository:
# synthetic molecules of drug-like size (20 to 70 atoms) stand in.
CONF_QMUGS = "configs_clean/pre-train_QMugs.yml"
CONF_DRUGS = "configs_clean/pre-train_GEOM-Drugs.yml"
CONF_CONFS = {CONF_QMUGS: 3, CONF_DRUGS: 5}
CONF_LOSS = "NTXentMultiplePositives"
CONF_DATA = {"seed": 0, "n_min": 20, "n_max": 70}
CONF_WIDTH = MODEL3D_PARAMETERS["hidden_dim"]
CONF_DEPTH = MODEL3D_PARAMETERS["propagation_depth"]
CONF_STEPS = {CONF_QMUGS: TRAIN_STEPS, CONF_DRUGS: 10}
# launches per step: phase 8's 2D side, and per Net3D layer the message
# MLP's edge combine, its backward and the mean's CSR sum (whose backward
# is plain PyTorch); per forward the same without the backward
_NET3D_FWD = {"edge_combine": CONF_DEPTH, "csr_sum": CONF_DEPTH}
_NET3D_STEP = dict(_NET3D_FWD, pair_segment_sum=CONF_DEPTH)
EXPECTED_CONF_STEP = {bf16: {n: v + _NET3D_STEP.get(n, 0) for n, v in
                             EXPECTED_STEP[bf16].items()}
                      for bf16 in (True, False)}
EXPECTED_CONF_FWD = {bf16: {n: v + _NET3D_FWD.get(n, 0) for n, v in
                            EXPECTED[bf16].items()} for bf16 in (True, False)}
# phase 18c: the QMugs config through the CLI, 1 epoch of 2 steps on 5000
# synthetic drug-size molecules (model pool 4000, validation 500, test
# 500); eval forwards: the validation, the best checkpoint's, the test set
CONF_CLI = {"dataset": "synthetic",
            "dataset_params": {"num": 5000, "n_min": CONF_DATA["n_min"],
                               "n_max": CONF_DATA["n_max"]},
            "num_train": 1000, "num_epochs": 1, "use_tensorboard": False,
            "bf16_compute": True}
CONF_CLI_STEPS, CONF_CLI_EVALS = 2, 3
# None: the entry points' default device, the card
CONF_DEVICE = None


# The QMugs step on the card against the CPU (18b) takes phase 8's bounds
# unchanged, at the state the main path leaves: the weights and
# running statistics after its 20 bf16 steps (`_state`).  At the seeded
# weights the flat Net3D's outputs cluster, so the loss's gradient in z1 is
# a small remainder and the bf16 PNA gradient is rounding noise: bf16 card
# against bf16 CPU L2 1.21, worst leaf 5.26; no bound there fails a
# gradient unrelated to the true one.  The phase prints that reading and
# holds nothing on it.  After the 20 steps (loss 6.22 -> 5.44) the
# gradient is signal.  Readings there (NVIDIA H100 80GB HBM3, 700 W), bf16
# card / CPU against the CPU's float32 step: PNA L2 0.288 / 0.284, worst
# leaf 0.587 / 0.516; Net3D L2 0.163 / 0.174, worst leaf 0.368 / 0.402;
# zero-gradient leaves 7.0e-3; float32 PNA L2 1.6e-3, worst leaf 1.5e-2,
# Net3D L2 2.0e-3.  Planted faults: the conformers packed graph-major read
# PNA L2 2.28 and Net3D 1.87; the d_max / d_min routing dropped (a fault of
# the PNA side alone) PNA L2 0.739 (limit 0.568); the dropped csr_mean
# gradient leaves 10 Net3D leaves without gradient.
def _conf_args(bf16: bool, config: str) -> dict:
    return dict(_train_args(bf16), model3d_type="Net3D", loss_func=CONF_LOSS,
                num_conformers=CONF_CONFS[config], dataset_params=CONF_DATA)


def conformer_batch(config: str, device="cuda"):
    """The batch of phase 18 for `config`: 500 synthetic drug-size
    molecules (seed 0) with their C conformers, packed molecule-major."""
    return conformer_batches(BATCH, CONF_CONFS[config], device=device,
                             **CONF_DATA)


def phase_conf_kernels(tag: str, g2, g3) -> dict:
    """Phase 18a: every kernel of the path at the shapes the path gives
    it, against its plain version on the same CUDA tensors.  The 2D side
    (`g2`, drug-size bond graphs) at the PNA width, as phases 3 and 7 hold
    them: rows 6 and 5 (`edge_combine`, `pair_segment_sum`), rows 2 and 8
    (`pna_stats`, `pna_stats_bwd`) and row 1 (`multi_reduce`, the float32
    step's).  Then, at the conformer batch `g3` (complete graphs,
    in-degree up to n_max - 1), rows 6 and 5 on every path their launchers
    pick at D = 20 (the step's: 8-byte pieces in bf16) and D = 21
    (element-wise gathers) in bf16 and float32, and row 7 (`csr_sum`) at
    both widths on every path its launcher picks (`_hold_csr_sum`: the
    stream at `g3`, the walk at `g2`).  All sum the same float32 terms in
    the same order and round once -> bit-exact.  Padding edges, set to 1e4
    in the inputs, must not count: rows 5 and 7 read no row past the
    ranges, and row 6 gives a padding edge its own `pe` row alone."""
    gen2 = torch.Generator(device="cuda").manual_seed(17)
    E2, K2 = g2.senders.shape[0], g2.max_deg
    print(f"[conf-kernels] {tag} 2D batch: N={g2.num_nodes} E={E2} (real "
          f"{int(g2.csr_row_ptr[-1])}) D={WIDTH} K={K2}")
    case = [("drug-size 2D batch", g2.csr_row_ptr, K2, E2, WIDTH)]
    errs2 = {"edge_combine": _max_err(_hold_edge_combine(
                 "conf-kernels", gen2, g2, (WIDTH,))),
             "pair_segment_sum": _max_err(_hold_pair_segment_sum(
                 "conf-kernels", gen2, g2, (WIDTH,))),
             "pna_stats": _max_err(_hold_pna_stats("conf-kernels", gen2,
                                                   case)),
             "pna_stats_bwd": _max_err(_hold_pna_stats_bwd("conf-kernels",
                                                           gen2, case))}
    errs2.update(_hold_walks("conf-kernels", gen2,
                             [case[0][:4] + ((WIDTH,),)], []))
    print(f"[conf-kernels] {tag} 2D batch: edge_combine and "
          f"pair_segment_sum bit-exact in bf16 and float32")
    N, E, D = g3.num_nodes, g3.senders.shape[0], CONF_WIDTH
    e_real = int(g3.csr_row_ptr[-1])
    print(f"[conf-kernels] {tag}: N={N} E={E} (real {e_real}) max in-degree "
          f"{g3.max_deg} graphs {int(g3.graph_mask.sum())}")
    gen = torch.Generator(device="cuda").manual_seed(18)
    widths = (D, D + 1)
    errs = {"edge_combine": _max_err(_hold_edge_combine(
                f"conf-kernels {tag}", gen, g3, widths)),
            "pair_segment_sum": _max_err(_hold_pair_segment_sum(
                f"conf-kernels {tag}", gen, g3, widths))}
    errs["csr_sum"] = _max_err(
        _hold_csr_sum(f"conf-kernels {tag}", gen, g3, widths)
        + _hold_csr_sum(f"conf-kernels {tag} 2D batch", gen, g2, widths))
    _merge_errs(errs, errs2)
    return errs


def _state(step) -> dict:
    """Both models' weights and running statistics, copied to the CPU."""
    return {name: {k: v.detach().cpu().clone()
                   for k, v in m.state_dict().items()}
            for name, m in (("model", step.model), ("model3d", step.model3d))}


def _conf_one_step(bf16: bool, dev: str, config: str, batches: dict,
                   state=None):
    """`_measure_step` of one multi-conformer step on `batches["g2"]`,
    `batches["g3"]`, from the seeded weights or from `state` (`_state`)."""
    step = build_step(_conf_args(bf16, config), torch.device(dev))
    if state is not None:
        step.model.load_state_dict(state["model"])
        step.model3d.load_state_dict(state["model3d"])
    return _measure_step(step, {"model": step.model,
                                "model3d": step.model3d},
                         step.prepare(batches["g2"], batches["g3"]))


def _graph_major(batches: dict, config: str):
    """The first planted fault of phase 18: the card's step reads the
    conformers packed graph-major (conformer 0 of every molecule, then
    conformer 1, ...), where the multi-positive loss reshapes
    molecule-major.  Returns the plant()."""
    from infomax3d_tpu_torch.graphs.batch import batch_graphs, bucket_for
    C = CONF_CONFS[config]
    ds = SyntheticMolecules(BATCH, num_conformers=C, **CONF_DATA)
    confs = [ds.graph3d(i, conformer=c) for c in range(C)
             for i in range(BATCH)]
    b = bucket_for(confs, BATCH * C)
    wrong = to_graph_batch(batch_graphs(confs, b), b, "cpu")

    def plant():
        right = batches["g3"]
        batches["g3"] = wrong
        return lambda: batches.__setitem__("g3", right)
    return plant


def _dropped_csr_mean_gradient():
    """The second planted fault: the CSR sum's backward (under `csr_mean`,
    the flat Net3D's aggregation) returns zeros.  Returns the undo."""
    mod = importlib.import_module("infomax3d_tpu_torch.ops.kernels.csr_sum")
    real = mod.CsrSum.backward

    def zeroed(ctx, d_s):
        receivers, = ctx.saved_tensors
        return (torch.zeros(receivers.shape[0], d_s.shape[1],
                            dtype=ctx.dtype, device=d_s.device), None, None)
    mod.CsrSum.backward = staticmethod(zeroed)
    return lambda: setattr(mod.CsrSum, "backward", staticmethod(real))


def _conf_instantiation(kname: str) -> str:
    """The start of the profiler's name of the instantiation that rows 5,
    6 and 7 take on the 3D side (bf16, D = 20, 32-bit indices): the
    8-byte vector of `vec_width`, for row 6 its 16-byte flat word, for row
    7 its stream."""
    vec = _vec_elems(torch.bfloat16, CONF_WIDTH)
    name, args = {
        "pair_segment_sum": ("pair_segment_sum_kernel",
                             f"{vec}, unsigned int>"),
        "edge_combine": ("edge_combine_kernel", f"{vec}, 8, unsigned int>"),
        "csr_sum": ("csr_sum_stream_kernel", f"{vec}, unsigned int>")}[kname]
    return f"{name}<__nv_bfloat16, {args}"


def _conf_profile(step, a, b, ms: float, tag: str, n: int = 3) -> dict:
    """torch.profiler over `n` warm steps: device busy ms per step, its
    idle share of the CUDA-event step time `ms`, kernels per step, the
    port's kernels (us per launch in the step) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step.step(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step.step(a, b)
        torch.cuda.synchronize()
    by_name = _profile_kernels(prof)
    if not by_name:
        print(f"[conf-profile] {tag}: the profiler recorded no device "
              f"activity; not measured")
        return {}
    busy = sum(us for us, _ in by_name.values()) / n / 1e3
    kernels = sum(c for _, c in by_name.values()) / n
    print(f"[conf-profile] {tag}: device busy {busy:.4f} ms of {ms:.4f} ms "
          f"per step (idle share {1 - busy / ms:.3f}), {kernels:.0f} kernels "
          f"per step")
    for kname, (us, launches) in _port_kernels(by_name).items():
        print(f"[conf-profile]   {kname}: {us / launches:.2f} us per launch "
              f"in the step, {launches / n:.0f} launches per step")
    _print_globals(by_name, n, "conf-profile")
    # rows 5, 6 and 7 on the 3D side: their bf16 instantiation at D = 20,
    # ms per launch
    in_step = {}
    for kname in ("pair_segment_sum", "edge_combine", "csr_sum"):
        needle = _conf_instantiation(kname)
        for name, (us, cnt) in by_name.items():
            if needle in name:
                in_step[kname] = us / cnt / 1e3
    for name, (us, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:12]:
        print(f"[conf-profile]   {us / n:9.2f} us/step  {cnt / n:5.0f}x  "
              f"{name[:90]}")
    return {"busy_ms": busy, "kernels": kernels, "in_step": in_step}


def _conf_time(config: str, sizes: dict, batches: dict, smi: str) -> dict:
    """Per dtype: ms per warm step (CUDA events over back-to-back steps),
    graphs/s, edges/s (2D + 3D, as bench.py counts them), the peak of
    `max_memory_allocated` over a step, and (bf16) the profile."""
    out = {}
    for bf16 in (True, False):
        torch.cuda.empty_cache()
        step = build_step(_conf_args(bf16, config), torch.device("cuda"))
        a, b = step.prepare(batches["g2"], batches["g3"])
        step.step(a, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step.step(a, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t = cuda_ms(lambda: step.step(a, b), iters=10)
        edges = sizes["edges_2d"] + sizes["edges_3d"]
        print(f"[conf] {config} step bf16={bf16}: {t:.4f} ms, "
              f"{BATCH / t * 1e3:.1f} graphs/s, {edges / t * 1e3:.1f} edges/s "
              f"({sizes['edges_2d']} 2D bond + {sizes['edges_3d']} 3D "
              f"complete-graph edges of {sizes['conformers']} conformers per "
              f"step; CUDA events over 10 warm steps); peak "
              f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; {smi}")
        out[bf16] = {"ms": t, "peak": peak}
        if bf16:
            out["profile"] = _conf_profile(step, a, b, t,
                                           f"{config} bf16 step")
        del step, a, b
    return out


def _read_ms(nbytes: int, flush) -> tuple:
    """Cold-L2 and warm device ms of `read_probe` (csrc/csr_sum.cu), a
    plain read of `nbytes` from a fresh buffer: the least time a kernel
    that reads that many bytes takes under `device_ms`."""
    fn = launcher("csr_sum", "read_probe", (ctypes.c_void_p,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p, ctypes.c_void_p))
    buf = torch.empty(nbytes // 16 * 16, dtype=torch.uint8, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def call():
        err = fn(buf.data_ptr(), buf.numel(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"read_probe launch failed ({err})")
    return (device_ms(call, iters=10, flush=flush),
            device_ms(call, iters=50, warmup=5))


def _conf_kernel_times(g3, in_step: dict, smi: str):
    """Rows 5, 6 and 7 at the conformer shape in the step's variant (bf16,
    D = 20; row 7 also in float32, the float32 step's 80-byte rows): cold-L2
    and warm device time, the plain version, the nearest
    PyTorch call (float32 `index_add_` by receiver, and by sender for row
    5's second half; row 6 has none), the bound (bytes over the H100's
    memory rate, operations over its float32 rate).  Row 5's bound counts
    each byte once; beside it stands the time of its bytes with ct read
    twice (the sender half's second pass through csc_perm from device
    memory), and the time of each half alone: the receiver half is row 3's
    walk (`csr_segment_sum`), the sender half row 4's (`snd_segment_sum`),
    both through `walk_rows` at the same vector width."""
    N, E, D = g3.num_nodes, g3.senders.shape[0], CONF_WIDTH
    e_real = int(g3.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(19)
    bf = torch.bfloat16
    ct = torch.randn(E, D, generator=gen, device="cuda").to(bf)
    hd, hs = (torch.randn(N, D, generator=gen, device="cuda").to(bf)
              for _ in range(2))
    pe = torch.randn(E, D, generator=gen, device="cuda").to(bf)
    ctf = ct.float()
    ct32 = torch.randn(E, D, generator=gen, device="cuda")
    recv = g3.receivers.long().clamp(max=N)
    send = g3.senders.long().clamp(max=N)
    acc = torch.zeros(N + 1, D, device="cuda")

    def library_pair():
        acc.zero_().index_add_(0, recv, ctf)
        acc.zero_().index_add_(0, send, ctf)

    cases = {
        "pair_segment_sum": (
            lambda: pair_segment_sum(ct, g3.csr_row_ptr, g3.csc_row_ptr,
                                     g3.csc_perm),
            lambda: pair_segment_sum_reference(ct, g3.csr_row_ptr,
                                               g3.csc_row_ptr, g3.csc_perm),
            e_real * D * 2 + 2 * (N + 1) * 4 + e_real * 4 + 2 * N * D * 2,
            2.0 * e_real * D, library_pair, "two float32 index_add_"),
        "edge_combine": (
            lambda: edge_combine(hd, hs, pe, g3.receivers, g3.senders),
            lambda: edge_combine_reference(hd, hs, pe, g3.receivers,
                                           g3.senders),
            2 * N * D * 2 + E * D * 2 + 2 * E * 4 + E * D * 2,
            2.0 * E * D, None, "no single PyTorch call"),
        "csr_sum": (
            lambda: csr_sum(ct, g3.csr_row_ptr),
            lambda: csr_sum_reference(ct, g3.csr_row_ptr),
            e_real * D * 2 + (N + 1) * 4 + N * D * 4, 1.0 * e_real * D,
            lambda: acc.zero_().index_add_(0, recv, ctf),
            "one float32 index_add_"),
        "csr_sum float32": (
            lambda: csr_sum(ct32, g3.csr_row_ptr),
            lambda: csr_sum_reference(ct32, g3.csr_row_ptr),
            e_real * D * 4 + (N + 1) * 4 + N * D * 4, 1.0 * e_real * D,
            lambda: acc.zero_().index_add_(0, recv, ct32),
            "one float32 index_add_"),
    }
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for name, (kern, plain, nbytes, flops, lib, note) in cases.items():
        warm = device_ms(kern, iters=50, warmup=5)
        ms = device_ms(kern, iters=10, flush=flush)
        plain_ms = device_ms(plain, iters=3, warmup=1)
        lib_ms = device_ms(lib, iters=50, warmup=5) if lib else None
        bound_ms, bound_by = _bound(nbytes, flops)
        step_ms = in_step.get(name)
        variant = "float32" if name.endswith("float32") else "bf16"
        print(f"[conf-times] {name.split()[0]} ({variant}, D={D}, conformer "
              f"shape N={N} E={E}): device {ms:.5f} ms cold-L2 median, "
              f"{warm:.5f} ms "
              f"warm, {_fmt(step_ms)} in the step (the 3D launch); plain "
              f"{plain_ms:.5f} ms; library {_fmt(lib_ms)} ({note}); bound "
              f"{bound_ms:.5f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e6:.1f} MFLOP f32); {bound_ms / ms:.2f} of the "
              f"bound cold; {smi}")
        if name.startswith("csr_sum"):
            read_ms = _read_ms(e_real * D * (4 if variant == "float32" else 2),
                               flush)
            print(f"[conf-times]   csr_sum ({variant}): a plain read of its "
                  f"messages' real rows (`read_probe`) {read_ms[0]:.5f} ms "
                  f"cold-L2, {read_ms[1]:.5f} ms warm: {read_ms[0] / ms:.2f} "
                  f"of the kernel's time cold")
        if name != "pair_segment_sum":
            continue
        twice = nbytes + e_real * D * 2
        halves = {
            "receiver half alone (csr_segment_sum)":
                lambda: csr_segment_sum(ct, g3.csr_row_ptr),
            "sender half alone (snd_segment_sum)":
                lambda: snd_segment_sum(ct, g3.csc_row_ptr, g3.csc_perm)}
        for half, fn in halves.items():
            cold_h = device_ms(fn, iters=10, flush=flush)
            warm_h = device_ms(fn, iters=50, warmup=5)
            print(f"[conf-times]   {name} {half}: {cold_h:.5f} ms cold-L2, "
                  f"{warm_h:.5f} ms warm")
        print(f"[conf-times]   {name}: ct read twice from device memory "
              f"{twice / 1e6:.2f} MB, {twice / PEAK_BYTES_PER_S * 1e3:.5f} ms "
              f"at {PEAK_BYTES_PER_S / 1e12} TB/s beside the bytes-once "
              f"bound {bound_ms:.5f} ms; {smi}")


def phase_conformers(smi: str, out_dir: Path) -> dict:
    """Phase 18: multi-conformer pre-training.  (b) 20 bf16 and 20 float32
    steps through `pretrain()` at pre-train_QMugs.yml (C = 3), 10 of each
    at pre-train_GEOM-Drugs.yml (C = 5), and (c) the QMugs config through
    the CLI: the main path.  (a) every kernel of the path at both configs'
    batches.  (b) one step of each dtype from the state the QMugs bf16 run
    left, held against the CPU with phase 8's bounds and three planted
    faults; each config's step time, rate, memory and profile, and rows 5,
    6 and 7 timed at its conformer shape.  Returns the main path's
    launches and each kernel's max |kernel - plain|."""
    import shutil
    # (b) the main path: the counts are set to 0 just before it
    _reset_counts()
    for config in (CONF_QMUGS, CONF_DRUGS):
        for bf16 in (True, False):
            steps = CONF_STEPS[config]
            before = _counts()
            out = pretrain(_conf_args(bf16, config), steps=steps,
                           device=CONF_DEVICE)
            after = _counts()
            per_step = {n: (after[n] - before[n]) / steps for n in after}
            _check(per_step == EXPECTED_CONF_STEP[bf16],
                   f"{config} launches per step {per_step} != "
                   f"{EXPECTED_CONF_STEP[bf16]}")
            losses = out["losses"]
            _check(all(np.isfinite(losses)), f"non-finite losses {losses}")
            _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
            print(f"[conf] {config} bf16={bf16}: {steps} steps through "
                  f"pretrain(), loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
                  f"sizes {out['sizes']}; launches per step {per_step}")
            if config == CONF_QMUGS and bf16:
                trained = _state(out["step"])
            del out
    # (c) the CLI, still on the main path's counts
    root = out_dir / "conformers"
    shutil.rmtree(root, ignore_errors=True)
    cli_run = _data_run(CONF_QMUGS, CONF_CLI, root, CONF_DEVICE)
    launches = _counts()
    want = _expect(EXPECTED_CONF_STEP[True], EXPECTED_CONF_FWD[True],
                   CONF_CLI_STEPS, CONF_CLI_EVALS)
    _check(cli_run["launches"] == want,
           f"CLI launches {cli_run['launches']} != {want}")
    for name in ("best_checkpoint.pt", "metrics.jsonl", "timing.json",
                 "evaluation_val_best_checkpoint.txt"):
        _check((cli_run["dir"] / name).exists(), f"CLI: no {name}")
    print(f"[conf] CLI {CONF_QMUGS} (bf16, 1 epoch of {CONF_CLI_STEPS} "
          f"steps, {CONF_CLI_EVALS} eval forwards): "
          f"{cli_run['wall_s']:.3f} s; result {cli_run['result']}; "
          f"launches {cli_run['launches']}")
    print(f"[conf] multi-conformer main-path launches: {launches}")

    # (a) the kernels at the QMugs and GEOM-Drugs conformer batches
    errs, sizes, batches = {}, {}, {}
    for config in (CONF_QMUGS, CONF_DRUGS):
        g2, g3, sizes[config] = conformer_batch(config, "cpu")
        batches[config] = {"g2": g2, "g3": g3}
        _merge_errs(errs, phase_conf_kernels(config, g2.to("cuda"),
                                             g3.to("cuda")))

    # (b) the QMugs step on the card against the CPU: at the seeded
    # weights read only, at the main path's state after its 20 bf16 steps
    # held (see above); then the timings
    qb = batches[CONF_QMUGS]
    sides, unbounded = ("model", "model3d"), {"model": float("inf"),
                                              "model3d": float("inf")}
    seeded = {dev: _conf_one_step(True, dev, CONF_QMUGS, qb)[1]
              for dev in ("cuda", "cpu")}
    _print_readings("seeded weights, bf16 card vs CPU (read, not held)",
                    _readings(seeded["cuda"], seeded["cpu"], sides),
                    unbounded, "conf")
    del seeded
    _hold_step_against_cpu(
        lambda bf16, dev: _conf_one_step(bf16, dev, CONF_QMUGS, qb,
                                         trained),
        sides,
        {"conformers packed graph-major": _graph_major(qb, CONF_QMUGS),
         "csr_mean gradient dropped": _dropped_csr_mean_gradient,
         "d_max / d_min routing dropped": _dropped_extremum_routing},
        "conf")
    timing = {}
    for config in (CONF_QMUGS, CONF_DRUGS):
        b = {k: v.to("cuda") for k, v in batches[config].items()}
        timing[config] = _conf_time(config, sizes[config], b, smi)
        _conf_kernel_times(b["g3"], timing[config].get("profile", {}).get(
            "in_step", {}), smi)
        del b
    return {"launches": launches, "errs": errs, "cli": cli_run}


# --- phase 19: the data layer on the card ------------------------------------

# The fixture of `tests/test_real_qm9_slice.py`: 12 QM9 molecules in raw
# V2000 SDF and the csv's raw column order.
QM9_FIXTURE = "tests/fixtures/qm9_slice"
# The fixture fine-tune: `tune_QM9_homo.yml` at its own widths (PNA
# 200x7), float32, batch 4, 8 of the 9-molecule model pool: 2 steps; the
# validation set (2 molecules) one batch, evaluated for the epoch and for
# the best checkpoint.  The test set is one molecule, whose r-squared is
# not defined: not evaluated.
FIXTURE_TUNE = {"bf16_compute": False, "batch_size": 4, "num_train": 8,
                "num_epochs": 1, "use_tensorboard": False,
                "pretrain_checkpoint": None, "eval_on_test": False}
FIXTURE_STEPS, FIXTURE_EVALS = 2, 2
# The OGB run: `configs/30.yml` (OGBGNN, GIN 5x300, batch 128) on a
# molhiv-shaped cache of 4096 synthetic molecules of 4 to 28 atoms and one
# binary target (about 3.5 % positive, as ogbg-molhiv), no stored split:
# the port computes the scaffold split.  One seed, no pre-trained
# weights, bf16, 1 epoch over the scaffold train set.
OGB_CONFIG = "configs/30.yml"
OGB_MOLECULES = 4096
OGB_POSITIVE_Z = 1.81
OGB_RUN = {"dataset": "ogbg-molhiv", "multithreaded_seeds": [],
           "pretrain_checkpoint": None, "num_epochs": 1,
           "bf16_compute": True, "use_tensorboard": False}
# a GIN forward (an eval batch) sums each layer's messages once
EXPECTED_GIN_FWD = dict(NONE, csr_sum=GIN_DEPTH)
# the cache-served runs of phases 17 and 18: the synthetic molecules of
# those phases (same seeds and sizes) written as caches
QM9_CACHE = {"num": 5000, "num_targets": 19, "n_min": 4, "n_max": 28}
QMUGS_CACHE = {"num": 5000, "num_conformers": CONF_CONFS[CONF_QMUGS],
               "n_min": CONF_DATA["n_min"], "n_max": CONF_DATA["n_max"]}
DATA_CACHE_RUN = {"dataset": "qm9", "dataset_params": {}, "num_epochs": 1}
DATA_STEPS, DATA_EVALS = 2, 3
# QMugs' split (the geom family's: a 5 % test set, 250 of 5000) holds less
# than one full batch of 500, and the contrastive loaders drop partial
# batches: the cache-served QMugs run evaluates no test set
QMUGS_CACHE_RUN = {"dataset": "qmugs", "dataset_params": {},
                   "eval_on_test": False}
QMUGS_CACHE_EVALS = 2


def _qm9_fixture_faults(path: str) -> list:
    """The facts `tests/test_real_qm9_slice.py:29-70` holds on the fixture
    cache at `path`; returns the ones that do not hold."""
    from infomax3d_tpu_torch.data.cached import HAR2EV, QM9Dataset
    z = np.load(path)
    af, sl = z["atom_features"], z["atom_slices"]
    c = z["coordinates"][:5]
    a0, r0 = int(sl[3]), int(sl[11])
    denorm = None
    ds = QM9Dataset(path, target_tasks=["homo", "r2"], normalize=True)
    denorm = ds.targets * ds.targets_std + ds.targets_mean
    facts = {
        "13 atom slices": sl.shape == (13,),
        "methane 5 atoms, 8 edges": (sl[1], z["edge_slices"][1]) == (5, 8),
        "feature widths 9, 3": (af.shape[1], z["edge_features"].shape[1])
        == (9, 3),
        "targets [12, 19]": z["targets"].shape == (12, 19),
        "C-H 1.0902": abs(np.linalg.norm(c[1] - c[0]) - 1.0902) < 1e-3,
        "methane C: code 5, degree 4, sp3": (af[0, 0], af[0, 2], af[0, 6])
        == (5, 4, 2),
        "acetylene C: sp": (af[a0, 0], af[a0, 6]) == (5, 0),
        "oxirane ring flags": bool(af[r0:r0 + 3, 8].all()) and af[0, 8] == 0,
        "homo -0.3877 Ha in eV": abs(denorm[0, 0] + 0.3877 * HAR2EV)
        <= 1e-5 * 0.3877 * HAR2EV,
        "r2 35.36": abs(denorm[0, 1] - 35.36) <= 1e-5 * 35.36,
        "ev2mev": ds.ev2mev.tolist() == [1000.0, 1.0],
    }
    return [k for k, ok in facts.items() if not ok]


def _raw_csv_order():
    """Phase 19's planted fault: the csv's columns left in raw order (no
    `_QM9_CSV_TO_CACHE`).  Returns the undo."""
    pre = importlib.import_module("infomax3d_tpu_torch.data.preprocess")
    real = pre._QM9_CSV_TO_CACHE
    pre._QM9_CSV_TO_CACHE = list(range(1, 20))
    return lambda: setattr(pre, "_QM9_CSV_TO_CACHE", real)


def _write_molhiv_cache(path: Path):
    """`write_synthetic_cache` with the target cut to one binary label."""
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    write_synthetic_cache(str(path), num=OGB_MOLECULES, seed=0,
                          num_targets=1, n_min=4, n_max=28)
    z = dict(np.load(path))
    z["targets"] = (z["targets"] > OGB_POSITIVE_Z).astype(np.float32)
    np.savez(path, **z)


def _timed_s(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _loader_s(run: dict, steps: int) -> tuple:
    t = json.load(open(run["dir"] / "timing.json"))
    return t["loader"], t["loader"] / steps


def _scaffold_split_checks(ds, split: dict):
    """8:1:1 by scaffold groups: every molecule in one part, no group
    across parts, train and validation within their caps."""
    from infomax3d_tpu_torch.data.splits import scaffold_key
    n = len(ds)
    parts = {k: np.asarray(v) for k, v in split.items()}
    allidx = np.sort(np.concatenate(list(parts.values())))
    _check(np.array_equal(allidx, np.arange(n)),
           "scaffold split does not cover every molecule once")
    _check(len(parts["train"]) <= int(0.8 * n)
           and len(parts["valid"]) <= int(0.1 * n),
           f"split sizes {[len(v) for v in parts.values()]} over the caps")
    keys = {k: {scaffold_key(ds.graph2d(int(i))) for i in v}
            for k, v in parts.items()}
    _check(not (keys["train"] & keys["valid"] or keys["train"] & keys["test"]
                or keys["valid"] & keys["test"]),
           "a scaffold group spans two parts")
    return {k: len(v) for k, v in parts.items()}, \
        {k: len(v) for k, v in keys.items()}


def phase_data(smi: str, out_dir: Path, synthetic: dict = None) -> dict:
    """Phase 19: the data layer.  (a) the port's `preprocess_qm9` on the
    QM9 fixture, its facts, and a planted fault (the csv in raw order)
    that must fail them; (b) caches written from phases 17 and 18's
    synthetic molecules and a molhiv-shaped one, QM9's items equal to
    `SyntheticDataset`'s, the OGB scaffold split; (c) the main path: the
    fixture fine-tune, the QM9 float32 and bf16 pre-trainings, the QMugs
    run and `configs/30.yml`'s GIN through the CLI from those caches,
    their launches, the float32 run against phase 17's; (d) the loader's
    host seconds per step beside the synthetic-served runs (`synthetic`:
    phases 17 and 18's runs with their train steps, keyed "pre_f32",
    "pre" and "qmugs"; the missing ones are run here).  Returns the main
    path's launches, the caches' root and the GIN run's best checkpoint."""
    import shutil
    from infomax3d_tpu_torch.cli.train import make_splits
    from infomax3d_tpu_torch.data.cached import (CachedMoleculeDataset,
                                                 QM9Dataset, SyntheticDataset)
    from infomax3d_tpu_torch.data.preprocess import preprocess_qm9
    from infomax3d_tpu_torch.data.splits import get_idx_split
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    root = out_dir / "data"
    shutil.rmtree(root, ignore_errors=True)
    synthetic = dict(synthetic or {})
    device = TRAINER_DEVICE

    # (a) real chemistry: the fixture through the port's preprocessing
    fixture = root / "fixture"
    _, s = _timed_s(lambda: preprocess_qm9(
        QM9_FIXTURE, str(fixture / "QM9" / "processed.npz")))
    bad = _qm9_fixture_faults(str(fixture / "QM9" / "processed.npz"))
    _check(not bad, f"QM9 fixture cache: {bad}")
    undo = _raw_csv_order()
    try:
        preprocess_qm9(QM9_FIXTURE, str(root / "fault" / "processed.npz"))
    finally:
        undo()
    caught = _qm9_fixture_faults(str(root / "fault" / "processed.npz"))
    _check("homo -0.3877 Ha in eV" in caught,
           f"the csv in raw order passed the homo check: {caught}")
    print(f"[data] QM9 fixture: preprocess_qm9 {s:.3f} s; every fact of "
          f"tests/test_real_qm9_slice.py holds; planted fault (csv columns "
          f"in raw order) caught: {caught}")

    # (b) the caches, each timed to write and to load
    caches = root / "caches"
    times = {}
    _, times["QM9 write"] = _timed_s(lambda: write_synthetic_cache(
        str(caches / "QM9" / "processed.npz"), seed=0, **QM9_CACHE))
    _, times["QMugs write"] = _timed_s(lambda: write_synthetic_cache(
        str(caches / "QMugs" / "processed.npz"), seed=0, num_targets=1,
        **QMUGS_CACHE))
    _, times["ogbg_molhiv write"] = _timed_s(lambda: _write_molhiv_cache(
        caches / "ogbg_molhiv" / "processed.npz"))
    qm9, times["QM9 load"] = _timed_s(lambda: QM9Dataset(
        str(caches / "QM9" / "processed.npz"), target_tasks=["homo"]))
    _, times["QMugs load"] = _timed_s(lambda: CachedMoleculeDataset(
        str(caches / "QMugs" / "processed.npz"), num_conformers=3))
    hiv, times["ogbg_molhiv load"] = _timed_s(lambda: CachedMoleculeDataset(
        str(caches / "ogbg_molhiv" / "processed.npz")))
    syn = SyntheticDataset(num=QM9_CACHE["num"], seed=0)
    for i in range(len(syn)):
        for view in ("graph2d", "graph3d"):
            a, b = getattr(qm9, view)(i), getattr(syn.ds, view)(i)
            _check(a.keys() == b.keys() and all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                for k in a), f"QM9 cache molecule {i} {view} differs")
    _check(qm9.max_in_degree() == syn.max_in_degree(), "max_in_degree")
    split, times["scaffold split"] = _timed_s(
        lambda: get_idx_split(hiv, hiv.cache_dir))
    sizes, groups = _scaffold_split_checks(hiv, split)
    print(f"[data] QM9 cache: graph2d / graph3d of all {len(syn)} molecules "
          f"equal SyntheticDataset's; molhiv scaffold split {sizes} "
          f"molecules in {groups} scaffold groups; host seconds {times}")
    del syn

    # (c) the main path: the counts are set to 0 just before it
    runs = {}
    _reset_counts()
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(fixture)}):
        runs["fixture tune"] = _data_run(TRAINER_TUNE, FIXTURE_TUNE,
                                         root / "fixture_tune", device)
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
        runs["qm9 pre f32"] = _data_run(
            TRAINER_PRE, dict(TRAINER_RUNS["pre"][1], **DATA_CACHE_RUN,
                              bf16_compute=False), root / "pre_f32", device)
        runs["qm9 pre bf16"] = _data_run(
            TRAINER_PRE, dict(TRAINER_RUNS["pre"][1], **DATA_CACHE_RUN),
            root / "pre_bf16", device)
        runs["qmugs"] = _data_run(CONF_QMUGS,
                                  dict(CONF_CLI, **QMUGS_CACHE_RUN),
                                  root / "qmugs", device)
        runs["ogbg-molhiv"] = _data_run(OGB_CONFIG, OGB_RUN, root / "hiv",
                                        device)
    launches = _counts()
    hiv_split = make_splits(runs["ogbg-molhiv"]["args"], hiv)
    ogb_steps = -(-len(hiv_split[0]) // GIN_BATCH)
    ogb_evals = 2 * -(-len(hiv_split[1]) // GIN_BATCH) \
        + -(-len(hiv_split[2]) // GIN_BATCH)
    plan = {
        "fixture tune": (EXPECTED_STEP[False], EXPECTED[False],
                         FIXTURE_STEPS, FIXTURE_EVALS),
        "qm9 pre f32": (EXPECTED_STEP[False], EXPECTED[False], DATA_STEPS,
                        DATA_EVALS),
        "qm9 pre bf16": (EXPECTED_STEP[True], EXPECTED[True], DATA_STEPS,
                         DATA_EVALS),
        "qmugs": (EXPECTED_CONF_STEP[True], EXPECTED_CONF_FWD[True],
                  CONF_CLI_STEPS, QMUGS_CACHE_EVALS),
        "ogbg-molhiv": (EXPECTED_GIN_STEP, EXPECTED_GIN_FWD, ogb_steps,
                        ogb_evals),
    }
    on_card = torch.device(device or "cuda").type == "cuda"
    for name, (step, fwd, steps, evals) in plan.items():
        run = runs[name]
        want = _expect(step, fwd, steps, evals) if on_card else dict(NONE)
        _check(run["launches"] == want,
               f"{name}: launches {run['launches']} != {want}")
        print(f"[data] {name}: {run['wall_s']:.3f} s, {steps} steps, "
              f"{evals} eval batches, launches {run['launches']}; result "
              f"{run['result']}")
    print(f"[data] data-layer main-path launches: {launches}")

    # the fixture fine-tune's denormalised MAE in the JAX test's range
    tune = runs["fixture tune"]["result"]
    scale_mev = float(QM9Dataset(str(fixture / "QM9" / "processed.npz"),
                                 target_tasks=["homo"]).targets_std[0]) * 1e3
    _check(0.01 * scale_mev < tune["mae_denormalized"] < 100 * scale_mev,
           f"fixture tune: mae_denormalized {tune['mae_denormalized']} "
           f"outside (0.01, 100) x {scale_mev}")
    hiv_args = runs["ogbg-molhiv"]["args"]
    _check(hiv_args["main_metric"] == "ogbg-molhiv"
           and "ogbg-molhiv" in runs["ogbg-molhiv"]["result"],
           f"ogbg-molhiv: main metric {hiv_args['main_metric']}")
    print(f"[data] fixture tune: mae_denormalized "
          f"{tune['mae_denormalized']:.3f} meV (homo std {scale_mev:.3f} "
          f"meV); ogbg-molhiv main metric ROC-AUC "
          f"{runs['ogbg-molhiv']['result']['ogbg-molhiv']:.6f}")

    # (d) the synthetic-served counterparts, each (run, train steps):
    # phase 17's float32 and bf16 pre-trainings and phase 18's QMugs run
    # (run here when not given), and the GIN config on SyntheticDataset
    if "pre_f32" not in synthetic:
        synthetic["pre_f32"] = (_cli_run(
            "pre", root / "syn_pre_f32", device, num_epochs=1,
            bf16_compute=False), DATA_STEPS)
    _hold_f32_run("[data] float32 1-epoch pre-training, QM9 cache vs "
                  "synthetic", runs["qm9 pre f32"], synthetic["pre_f32"][0])
    if "pre" not in synthetic:
        synthetic["pre"] = (_cli_run("pre", root / "syn_pre", device,
                                     num_epochs=1), DATA_STEPS)
    if "qmugs" not in synthetic:
        synthetic["qmugs"] = (_data_run(CONF_QMUGS, CONF_CLI,
                                        root / "syn_qmugs", device),
                              CONF_CLI_STEPS)
    synthetic["ogbg-molhiv"] = (_data_run(
        OGB_CONFIG, dict(OGB_RUN, dataset="synthetic", dataset_params={
            "num": OGB_MOLECULES, "n_min": 4, "n_max": 28},
            num_train=len(hiv_split[0])), root / "syn_hiv", device),
        ogb_steps)
    loader = {}
    for name, syn_name in (("qm9 pre f32", "pre_f32"), ("qm9 pre bf16", "pre"),
                           ("qmugs", "qmugs"),
                           ("ogbg-molhiv", "ogbg-molhiv")):
        steps = plan[name][2]
        total, per = _loader_s(runs[name], steps)
        syn_run, syn_steps = synthetic[syn_name]
        syn_total, syn_per = _loader_s(syn_run, syn_steps)
        loader[name] = (per, syn_per)
        print(f"[data] {name} loader host s per train step (waits on the "
              f"prefetch thread, train and eval batches): cache "
              f"{per:.6f} ({total:.6f} s / {steps} steps) against "
              f"synthetic {syn_per:.6f} ({syn_total:.6f} s / {syn_steps} "
              f"steps); {smi}")
    return {"launches": launches, "caches": caches, "loader": loader,
            "gin_ckpt": runs["ogbg-molhiv"]["dir"] / "best_checkpoint.pt"}


# --- phase 20: the serving CLI ---------------------------------------------

# A seeded fragment grammar of drug-like SMILES (the card's machine has no
# RDKit and the repository no SMILES set of that size): rings (benzene,
# heteroaromatics, fused bicycles, saturated heterocycles, a pyridinium)
# joined by linkers (amides, esters, ethers, a sulfonyl, alkenes, alkynes,
# a quaternary ammonium), ring carbons carrying substituents (halogens,
# methoxy, CF3, nitrile, nitro, carboxylate, ammonium).  "{}" marks a
# carbon that may carry one; the chain enters a ring at its first atom and
# leaves from its last.  Every string is in the subset `data/chem.py`
# parses.
SMILES_RINGS = (
    "c1cc{}ccc1", "c1cc{}ncc1", "c1cc{}sc1", "c1cc{}oc1", "c1cc[nH]c1",
    "c1cc{}c2ccccc2c1", "c1ccc2[nH]ccc2c1", "c1cc{}c2ncccc2c1",
    "c1ccc2[nH]cnc2c1", "c1cc[n+](C)cc1", "C1CC{}CCC1", "C1CCNCC1",
    "N1CCN(C)CC1", "C1COCCN1", "C1CC{}C1", "c1nc{}cs1", "c1ncnc{}c1",
    "C1CC2CCC{}C2C1",
)
SMILES_LINKERS = ("C", "CC", "C(=O)N", "NC(=O)", "O", "S(=O)(=O)", "N",
                  "C=C", "C#C", "OC(=O)", "CN", "C(C)", "CO", "[N+](C)(C)")
SMILES_SUBSTITUENTS = ("(F)", "(Cl)", "(Br)", "(C)", "(O)", "(OC)", "(N)",
                       "(C(F)(F)F)", "(C#N)", "([N+](=O)[O-])",
                       "(C(=O)[O-])", "(CC[NH3+])", "(I)", "(SC)")
_HEAVY_ATOM = r"\[[^\]]+\]|Br|Cl|[BCNOPSFI]|[cnops]"


def drug_smiles(num: int, seed: int, n_min: int = 20,
                n_max: int = 70) -> list:
    """`num` SMILES of `n_min` to `n_max` heavy atoms (each size drawn
    uniformly, rings and linkers appended until it is reached, longer ones
    drawn again), from `np.random.default_rng(seed)`."""
    import re
    rng = np.random.default_rng(seed)

    def pick(options):
        return options[rng.integers(len(options))]

    def ring():
        return re.sub(r"\{\}", lambda _: pick(SMILES_SUBSTITUENTS)
                      if rng.random() < 0.6 else "", pick(SMILES_RINGS))

    def heavy(s):
        return len(re.findall(_HEAVY_ATOM, s))
    out = []
    while len(out) < num:
        target = int(rng.integers(n_min, n_max + 1))
        s = ring()
        while heavy(s) < target:
            s += pick(SMILES_LINKERS) + ring()
        if heavy(s) <= n_max:
            out.append(s)
    return out


# Phase 20's requests.  (b) the main request: 5000 SMILES at the
# checkpoint of phase 18c (`pre-train_QMugs.yml`'s PNA 200x7, target 256,
# batch 500, from its train_arguments.yaml); (c) the first 500 of them on
# the CPU.  Both training runs asked for bf16 explicitly (`bf16_compute:
# True` in their train_arguments.yaml, which serving would honour); the
# serving configs ask for the default, "auto": float32.
SERVE_MOLECULES = 5000
SERVE_SEED = 0
SERVE_CPU = 500
SERVE_CONFIG = {"bf16_compute": "auto"}
# The card against the CPU, float32 serving, relative to max|CPU|: phase
# 4's float32 bound (matmuls in full float32 on both, TF32 off; only the
# summation order differs).  The planted fault is the defect this slice
# repairs, serving "auto" in bf16 on the card: it must exceed the bound.
# Readings (NVIDIA H100 80GB HBM3, 700.00 W): PNA 200x7 2.29e-6, the
# fault 1.08e-2; GIN 5x300 5.99e-7.
SERVE_TOL = SLICE_TOL[False]
# The JAX fixture (`tools/make_jax_serving_fixture.py`): its 64 SMILES
# through the JAX CLI on a CPU, stored; the card against them, relative
# to max|JAX|, as the CPU test holds the port (it reads 4.7e-7 there,
# tests/test_torch_port_inference.py; the card 3.93e-7)
JAX_FIXTURE = Path("tests/fixtures/jax_serving")
JAX_SERVE_TOL = 1e-5
# the fixture's PNA 16x2 at its batch of 32: 2 forwards of 64 SMILES
JAX_FIXTURE_FWD = dict(NONE, edge_combine=2, multi_reduce=2)
JAX_FIXTURE_BATCHES = 2


def _write_yaml(path: Path, cfg: dict) -> str:
    from infomax3d_tpu_torch.cli import yaml_lite
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml_lite.dump(cfg, f)
    return str(path)


def _serve(argv: list) -> tuple:
    """`cli.inference.main(argv)` with its timing and launches."""
    import contextlib
    import io
    from infomax3d_tpu_torch.cli.inference import main as serve_main
    timing, text = {}, io.StringIO()
    before = _counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        fp = serve_main(argv, timing=timing)
    timing["e2e_s"] = time.perf_counter() - t0
    after = _counts()
    return fp, timing, {n: after[n] - before[n] for n in after}


def _serve_numbers(tag: str, source: str, n: int, timing: dict,
                   launches: dict, smi: str):
    fwd = timing["forward_ms"]
    print(f"[serve] {tag}: {source} {timing['data_s']:.6f} s host; "
          f"collate {timing['collate_s']:.6f} s host (loader thread); "
          f"device forward {np.mean(fwd):.6f} ms "
          f"per batch (CUDA events, {len(fwd)} batches, {min(fwd):.6f} to "
          f"{max(fwd):.6f}); end to end {n / timing['e2e_s']:.3f} "
          f"molecules/s ({n} molecules, {timing['e2e_s']:.6f} s, input "
          f"to fingerprints.npy); kernels per request {launches}; "
          f"{smi}")


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _serve_forward_profile(tag: str, cfg: str, dataset, bs: int,
                           in_request: list, smi: str, n: int = 5):
    """One batch of `bs` molecules of `dataset` in the serving bucket
    through the model of `cfg`, outside a request: back to back (CUDA
    events, the host's launches included), device time alone
    (`device_ms`), and torch.profiler's busy time, kernels per forward and
    top kernels, beside the request's per-batch forward (`in_request`,
    ms)."""
    from torch.profiler import ProfilerActivity, profile
    from infomax3d_tpu_torch.cli.inference import (build_model, parse_args,
                                                   serving_bucket)
    from infomax3d_tpu_torch.data.loader import graph_only_collate, to_device
    args, _ = parse_args(["--config", cfg])
    g = to_device(graph_only_collate([dataset[i] for i in range(bs)],
                                     serving_bucket(dataset, bs))["graph"],
                  "cuda")
    model = build_model(args, "cuda")
    with torch.inference_mode():
        back = cuda_ms(lambda: model(g), iters=20)
        alone = device_ms(lambda: model(g), iters=10)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model(g)
            torch.cuda.synchronize()
    by_name = _profile_kernels(prof)
    busy = sum(us for us, _ in by_name.values()) / n / 1e3
    if by_name:
        kernels = f"{sum(c for _, c in by_name.values()) / n:.0f}"
        busy_s, idle = f"{busy:.4f} ms", f"{1 - busy / back:.3f}"
    else:
        kernels = busy_s = idle = "not measured"
    print(f"[serve] {tag} forward of one batch of {bs} (N = {g.num_nodes}, "
          f"E = {g.senders.shape[0]} in the serving bucket), outside the "
          f"request: {back:.4f} ms back to back (CUDA events over 20), "
          f"{alone:.4f} ms device time alone, busy {busy_s} (idle share "
          f"{idle} of back to back), {kernels} kernels per forward; in the "
          f"request {float(np.mean(in_request)):.4f} ms (median "
          f"{float(np.median(in_request)):.4f}); {smi}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, cnt) in top:
        print(f"[serve]   {us / n:9.2f} us/fwd  {cnt / n:5.0f}x  {name[:90]}")


def phase_serving(smi: str, out_dir: Path, qmugs_ckpt: Path,
                  gin_ckpt: Path, caches: Path) -> dict:
    """Phase 20: the serving CLI as users run it.  (a) 5000 drug-like
    SMILES from the fragment grammar; the main path: (b) the full-width
    PNA of phase 18c's checkpoint serves them through
    `cli.inference.main`, (c) the JAX fixture's SMILES from its flax
    msgpack checkpoint, (d) one fine-tune step transferring from that
    checkpoint, (e) `configs/30.yml`'s GIN from phase 19's checkpoint over
    its molhiv-shaped cache, (f) `cli.analysis.main` on (b)'s request;
    then the CPU's fingerprints of (b)'s first 500 SMILES, (e)'s and the
    planted fault.  Returns the main path's launches."""
    import contextlib
    import io
    import shutil
    from infomax3d_tpu_torch.cli import analysis
    from infomax3d_tpu_torch.cli.inference import SmilesDataset, parse_args
    from infomax3d_tpu_torch.cli.train import build_dataset, make_splits
    root = out_dir / "serving"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    # (a) the SMILES
    smiles = drug_smiles(SERVE_MOLECULES, SERVE_SEED)
    (root / "smiles.txt").write_text("\n".join(smiles) + "\n")
    (root / "smiles_cpu.txt").write_text("\n".join(smiles[:SERVE_CPU])
                                         + "\n")
    pna = dict(SERVE_CONFIG, checkpoint=str(qmugs_ckpt))
    cfg = _write_yaml(root / "serve.yml", dict(
        pna, smiles_txt_path=str(root / "smiles.txt"),
        output_path=str(root / "fingerprints.npy")))
    fx = json.loads((JAX_FIXTURE / "fixture.json").read_text())
    cfg_fx = _write_yaml(root / "serve_jax.yml", {
        "smiles_txt_path": str(JAX_FIXTURE / "smiles.txt"),
        "output_path": str(root / "fingerprints_jax.npy")})
    gin = dict(SERVE_CONFIG, checkpoint=str(gin_ckpt))
    cfg_gin = _write_yaml(root / "serve_gin.yml", dict(
        gin, output_path=str(root / "fingerprints_gin.npy")))
    cfg_an = _write_yaml(root / "analysis.yml", dict(
        pna, smiles_txt_path=str(root / "smiles.txt"),
        output_dir=str(root / "analysis")))

    # the main path: the counts are set to 0 just before it
    _reset_counts()
    fp, timing, per_req = _serve(["--config", cfg])
    fp_fx, _, fx_req = _serve(["--config", cfg_fx, "--checkpoint",
                               str(JAX_FIXTURE / "best_checkpoint.pt")])
    tune = _data_run(fx["tune_config"], dict(
        fx["tune_overrides"],
        pretrain_checkpoint=str(JAX_FIXTURE / "best_checkpoint.pt")),
        root / "tune", None)
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
        fp_gin, gin_timing, gin_req = _serve(["--config", cfg_gin])
    an_before = _counts()
    with contextlib.redirect_stdout(io.StringIO()):
        payload = analysis.main(["--config", cfg_an])
    an_after = _counts()
    launches = _counts()

    # (b) the full-width request
    batches = -(-SERVE_MOLECULES // BATCH)
    _check(fp.shape == (SERVE_MOLECULES, MODEL_PARAMETERS["target_dim"]),
           f"fingerprints {fp.shape}")
    _check(bool(np.isfinite(fp).all()), "non-finite fingerprints")
    want = {n: v * batches for n, v in EXPECTED[False].items()}
    _check(per_req == want, f"PNA request launches {per_req} != {want}")
    an_req = {n: an_after[n] - an_before[n] for n in an_after}
    _check(an_req == want, f"analysis request launches {an_req} != {want}")
    _serve_numbers(f"PNA 200x7 (phase 18c's QMugs checkpoint, float32, "
                   f"batch {BATCH})", "SMILES read, parsed and featurized",
                   SERVE_MOLECULES, timing, per_req, smi)
    _serve_forward_profile("PNA 200x7", cfg,
                           SmilesDataset(str(root / "smiles_cpu.txt")),
                           BATCH, timing["forward_ms"], smi)
    # (c) the JAX checkpoint against the JAX CLI's fingerprints
    ref = np.load(JAX_FIXTURE / "fingerprints.npy")
    want_fx = {n: v * JAX_FIXTURE_BATCHES for n, v in JAX_FIXTURE_FWD.items()}
    _check(fx_req == want_fx, f"JAX fixture launches {fx_req} != {want_fx}")
    rel = _rel(fp_fx, ref)
    _check(fp_fx.shape == ref.shape and rel <= JAX_SERVE_TOL,
           f"JAX fixture: {fp_fx.shape}, card vs JAX {rel:.3g} > "
           f"{JAX_SERVE_TOL}")
    print(f"[serve] JAX msgpack checkpoint (PNA 16x2): {fp_fx.shape} "
          f"against the JAX CLI's stored fingerprints rel {rel:.3g} (tol "
          f"{JAX_SERVE_TOL}); launches {fx_req}")
    # (d) the transfer from the JAX checkpoint
    line = next(x for x in tune["text"].splitlines()
                if x.startswith("transferred "))
    _check(int(line.split()[1]) == fx["transfer_count"],
           f"transfer from the JAX checkpoint: {line} != "
           f"{fx['transfer_count']} (the JAX CLI's)")
    _, val_idx, test_idx = make_splits(tune["args"],
                                       build_dataset(tune["args"]))
    bs = tune["args"]["batch_size"]
    evals = 2 * -(-len(val_idx) // bs) + -(-len(test_idx) // bs)
    small = dict(NONE, edge_combine=2, pna_stats=2, pair_segment_sum=2,
                 pna_stats_bwd=2)
    want_tune = _expect(small, dict(NONE, edge_combine=2, pna_stats=2), 1,
                        evals)
    _check(tune["launches"] == want_tune,
           f"fine-tune launches {tune['launches']} != {want_tune}")
    print(f"[serve] fine-tune from the JAX checkpoint (bf16, 1 step, "
          f"{evals} eval forwards): {line.split(' from ')[0]}, the JAX "
          f"CLI's {fx['transfer_count']}; result {tune['result']}; "
          f"launches {tune['launches']}")
    # (e) GIN over the molhiv cache
    gin_batches = -(-fp_gin.shape[0] // GIN_BATCH)
    want_gin = {n: v * gin_batches for n, v in EXPECTED_GIN_FWD.items()}
    _check(gin_req == want_gin, f"GIN launches {gin_req} != {want_gin}")
    _check(fp_gin.shape == (OGB_MOLECULES, 1)
           and bool(np.isfinite(fp_gin).all()), f"GIN {fp_gin.shape}")
    # (f) the spectrum
    spec = np.asarray(payload["singular_values_pct"])
    _check(bool(np.isfinite(spec).all()) and bool(np.all(np.diff(spec) <= 0))
           and abs(spec.sum() - 100) < 1e-3
           and (root / "analysis" / "singular_values.json").exists(),
           f"spectrum: sum {spec.sum()}, {spec[:5]}")
    fp_an = np.load(root / "analysis" / "fingerprints.npy")
    print(f"[serve] analysis: {payload['n_samples']} x {payload['dim']}, "
          f"top-5 singular values (%) {np.round(spec[:5], 4).tolist()}, "
          f"sum {spec.sum():.6f}; its request against the first: max |diff| "
          f"{float(np.abs(fp_an - fp).max()):.3g}; launches {an_req}")
    print(f"[serve] serving main-path launches: {launches}")

    # the card against the CPU, and the planted fault
    fp_cpu, cpu_timing, _ = _serve(["--config", _write_yaml(
        root / "serve_cpu.yml", dict(
            pna, smiles_txt_path=str(root / "smiles_cpu.txt"),
            output_path=str(root / "fingerprints_cpu.npy"))),
        "--device", "cpu"])
    rel = _rel(fp[:SERVE_CPU], fp_cpu)
    _check(rel <= SERVE_TOL, f"PNA card vs CPU {rel:.3g} > {SERVE_TOL}")
    fault, _, fault_req = _serve(["--config", _write_yaml(
        root / "serve_fault.yml", dict(
            pna, bf16_compute=True,
            smiles_txt_path=str(root / "smiles_cpu.txt"),
            output_path=str(root / "fingerprints_fault.npy")))])
    rel_fault = _rel(fault, fp_cpu)
    _check(rel_fault > SERVE_TOL and fault_req["pna_stats"] > 0,
           f"planted fault (bf16 serving) passed: {rel_fault:.3g}")
    print(f"[serve] PNA card vs CPU (first {SERVE_CPU}): rel {rel:.3g} "
          f"(tol {SERVE_TOL}); planted fault, the same request served in "
          f"bf16 on the card: rel {rel_fault:.3g}, caught; CPU request "
          f"{SERVE_CPU / cpu_timing['e2e_s']:.3f} molecules/s; {smi}")
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
        fp_gin_cpu, _, _ = _serve(["--config", _write_yaml(
            root / "serve_gin_cpu.yml", dict(
                gin, output_path=str(root / "fingerprints_gin_cpu.npy"))),
            "--device", "cpu"])
    rel = _rel(fp_gin, fp_gin_cpu)
    _check(rel <= SERVE_TOL, f"GIN card vs CPU {rel:.3g} > {SERVE_TOL}")
    print(f"[serve] GIN 5x300 card vs CPU ({fp_gin.shape[0]} molecules): "
          f"rel {rel:.3g} (tol {SERVE_TOL})")
    _serve_numbers(f"GIN 5x300 (phase 19's ogbg-molhiv checkpoint, float32, "
                   f"batch {GIN_BATCH}, from the cache)",
                   "cache loaded (build_dataset)", OGB_MOLECULES,
                   gin_timing, gin_req, smi)
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
        _serve_forward_profile(
            "GIN 5x300", cfg_gin,
            build_dataset(parse_args(["--config", cfg_gin])[0]), GIN_BATCH,
            gin_timing["forward_ms"], smi)
    return {"launches": launches}


# ------------------------------------------------- phase 21: the baselines

BASE_CONFIGS = {"a": "configs_clean/pre-train_distance_predictor_baseline.yml",
                "b": "configs/contrastive_training_Net3DAE.yml",
                "c": "configs_clean/pre-train_graphCL_baseline.yml"}
BASE_NAMES = {"a": "distance predictor", "b": "Net3DAE autoencoder",
              "c": "GraphCL"}
# Each configuration's fixed synthetic batch (the step checks, launches
# and timings): QM9-size molecules (4 to 28 atoms, as the QM9 cache) at
# the configs' own batches of 100 and 50 for (a) and (b); drug-size
# molecules (20 to 70 atoms) for (c), timed at its batch of 500 and held
# card against CPU at 100 (the CPU's float32 step at 500 would take most
# of the phase).
BASE_DATA = {"a": {"seed": 0, "n_min": 4, "n_max": 28},
             "b": {"seed": 0, "n_min": 4, "n_max": 28},
             "c": {"seed": 0, "n_min": 20, "n_max": 70}}
BASE_CHECK_BATCH = {"a": 100, "b": 50, "c": 100}
BASE_TIMED_STEPS = 10
# launches per bf16 step by side: a PNA 200x7 pass runs rows 6, 2, 5 and 8
# once a layer (GraphCL runs two passes); Net3DAE's 2 encoder layers run
# row 6, its backward row 5 and the mean's row 7 (whose backward is plain
# PyTorch); a distance head on its pair view runs row 6 for each half and
# row 5 for each half's backward, at the head's first width: 1 for (a)
# (one layer to target_dim 1), the projection's 70 for (b) (2 layers), on
# (b)'s own complete-graph edges
BASE_AE_DEPTH = 2
_PNA_PASS = dict(edge_combine=DEPTH, pna_stats=DEPTH, pair_segment_sum=DEPTH,
                 pna_stats_bwd=DEPTH)
_PAIR_HEAD = {"edge_combine": 2, "pair_segment_sum": 2}
BASE_SIDES = {
    "a": {"2D": _PNA_PASS, "pair view": _PAIR_HEAD},
    "b": {"2D": _PNA_PASS,
          "3D": {"edge_combine": BASE_AE_DEPTH,
                 "pair_segment_sum": BASE_AE_DEPTH, "csr_sum": BASE_AE_DEPTH},
          "pair view": _PAIR_HEAD},
    "c": {"2D": {n: 2 * v for n, v in _PNA_PASS.items()}}}
# launches per eval forward (bf16): the forwards of the sides above
BASE_FWD = {"a": dict(NONE, edge_combine=DEPTH + 2, pna_stats=DEPTH),
            "b": dict(NONE, edge_combine=DEPTH + BASE_AE_DEPTH + 2,
                      pna_stats=DEPTH, csr_sum=BASE_AE_DEPTH),
            "c": dict(NONE, edge_combine=2 * DEPTH, pna_stats=2 * DEPTH)}
# The CLI runs (the main path): 1 epoch of 3 steps at each config's batch,
# bf16, on phase 19's caches (or this phase's own, run alone): QM9, 5000
# QM9-size molecules, for (a) and (b); QMugs, 5000 drug-size molecules, for
# (c).  Then tune_QM9_homo.yml 1 step of 128 from (a)'s checkpoint.
BASE_CLI_COMMON = {"dataset_params": {}, "num_epochs": 1,
                   "eval_on_test": False, "use_tensorboard": False,
                   "bf16_compute": True, "multithreaded_seeds": []}
BASE_CLI = {"a": {"dataset": "qm9", "num_train": 300},
            "b": {"dataset": "qm9", "num_train": 150},
            "c": {"dataset": "qmugs", "num_train": 1500}}
BASE_TUNE = {"dataset": "qm9", "num_train": 128, "batch_size": 128}
# The JAX CLI's transfer from a distance-predictor checkpoint under
# tune_QM9_homo.yml's transfer_layers [gnn] and exclude_from_transfer
# [batch_norm]: every `node_gnn` tensor but the BatchNorms', the 12
# embedding tables and each layer's 2 pretrans and 1 posttrans Linears'
# weight and bias (tests/test_torch_port_pretrain_baselines.py holds the
# port's count to the JAX CLI's on such checkpoints).
BASE_TRANSFER = 12 + DEPTH * 3 * 2
# The float32 step on the card against the CPU: phase 8's float32 bounds
# (STEP_TOL[False]: loss 1e-5, each leaf 5e-2 of its max, each model's
# gradient L2 5e-3, zero-gradient leaves 1e-4 of the model's largest
# gradient, running statistics 1e-4); the zero-gradient leaves are the ones
# whose CPU gradient is below 1e-6 of the model's largest.  Then one Adam
# step on each side: each updated weight within 2 lr (Adam's first step
# moves a weight by lr times its gradient's sign, which rounding may flip
# where the gradient is at rounding level) and within BASE_FIRM_TOL of
# max(|w|, 1) where the CPU gradient exceeds 1e-2 of its leaf's max and
# BASE_FIRM_GRAD (100 times Adam's eps: below it the step lr g / (|g| +
# eps) moves with the gradient's own rounding, not only its sign).
BASE_FIRM_TOL = 1e-6
BASE_FIRM_GRAD = 1e-6


def _base_args(kind: str, bf16: bool) -> dict:
    """The configuration's YAML as `load_config` reads it, at its full
    widths, with the compute dtype and seed 0."""
    from infomax3d_tpu_torch.cli.config import load_config
    return dict(load_config(BASE_CONFIGS[kind], {}), bf16_compute=bf16,
                seed=0)


def _base_step(kind: str, bf16: bool, dev: str, batch_size: int):
    """(step, prepared batches, sizes) of configuration `kind` from the
    seeded weights on its fixed batch."""
    from infomax3d_tpu_torch.train.baselines import (baseline_batches,
                                                     build_baseline_step)
    args = _base_args(kind, bf16)
    step = build_baseline_step(args, torch.device(dev))
    batches, sizes = baseline_batches(args, batch_size, device=dev,
                                      **BASE_DATA[kind])
    return step, step.prepare(*batches), sizes


def _base_models(step) -> dict:
    models = {"model": step.model}
    if getattr(step, "model3d", None) is not None \
            and step.model3d is not step.model:
        models["model3d"] = step.model3d
    return models


def _base_one_step(kind: str, dev: str):
    """The float32 step's loss, gradients and running statistics
    (`_measure_step`), then the weights after one Adam step."""
    step, prepared, _ = _base_step(kind, False, dev, BASE_CHECK_BATCH[kind])
    models = _base_models(step)
    loss, out = _measure_step(step, models, prepared)
    step.optimizer.step()
    new = {f"{k}.{n}": p.detach().float().cpu() for k, m in models.items()
           for n, p in m.named_parameters()}
    return loss, out, new, step.optimizer.param_groups[0]["lr"]


def _dropped_backward_half():
    """(a)'s planted fault: the distance net's second half (receiver
    columns first) left out, ``softplus(dn([h_s, h_r]))``."""
    mod = importlib.import_module("infomax3d_tpu_torch.models.transformer")
    real = mod.symmetric_distances

    def one_half(dn, h, pairs):
        return torch.nn.functional.softplus(
            dn(mod.pair_input(h, pairs), pairs.edge_mask))
    mod.symmetric_distances = one_half
    return lambda: setattr(mod, "symmetric_distances", real)


def _zeroed_reconstruction():
    """(b)'s planted fault: NTXentAE's reconstruction term zeroed."""
    mod = importlib.import_module("infomax3d_tpu_torch.losses.contrastive")
    real = mod.NTXentAE.__call__

    def zeroed(self, *a, **kw):
        lc, lr = real(self, *a, **kw)
        return lc, lr * 0.0
    mod.NTXentAE.__call__ = zeroed
    return lambda: setattr(mod.NTXentAE, "__call__", real)


def _view1_twice():
    """(c)'s planted fault: the model reads view1 where it should read
    view2."""
    mod = importlib.import_module("infomax3d_tpu_torch.train.baselines")
    real = mod.GraphCLStep.outputs
    mod.GraphCLStep.outputs = lambda self, v1, v2, noise=None: real(
        self, v1, v1, noise)
    return lambda: setattr(mod.GraphCLStep, "outputs", real)


BASE_FAULTS = {"a": ("the distance net's bwd half dropped",
                     _dropped_backward_half),
               "b": ("the reconstruction term zeroed", _zeroed_reconstruction),
               "c": ("view2 replaced by view1", _view1_twice)}


def _base_violations(card, cpu, lr) -> list:
    """What a float32 step on the card breaks of the check against the CPU
    step (see BASE_FIRM_TOL)."""
    (loss_card, g_card, new_card, _), (loss_cpu, g_cpu, new_cpu, _) = \
        card, cpu
    bad = []
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    if rel > STEP_TOL[False]["loss"]:
        bad.append(f"loss {rel:.3g}")
    sides = sorted({k.split(".")[0] for k in g_cpu})
    zero = []
    for side in sides:
        keys = [k for k in g_cpu if k.startswith(side + ".")
                and "running" not in k and g_cpu[k] is not None]
        gmax = max(float(g_cpu[k].abs().max()) for k in keys)
        zero += [k for k in keys if float(g_cpu[k].abs().max()) < 1e-6 * gmax]
    r = _readings(g_card, g_cpu, tuple(sides), tuple(zero))
    bad += _violations(r, STEP_TOL[False],
                       {s: STEP_TOL[False]["l2"] for s in sides})
    for k, w in new_cpu.items():
        got, g = new_card[k], g_cpu[k]
        if float((got - w).abs().max()) > 2 * lr * (1 + 1e-3):
            bad.append(f"{k}: updated weight off by more than 2 lr")
        if g is None or k in zero:
            continue
        firm = (g.abs() > 1e-2 * g.abs().max()) & (g.abs() > BASE_FIRM_GRAD)
        if bool(firm.any()) and float((got - w).abs()[firm].max()) > \
                BASE_FIRM_TOL * max(float(w.abs().max()), 1.0):
            bad.append(f"{k}: updated weight off by "
                       f"{float((got - w).abs()[firm].max()):.3g} where the "
                       f"gradient is firm (leaf max |g| "
                       f"{float(g.abs().max()):.3g})")
    return bad, r


def _launch_sides():
    """Patches each kernel module's `_launch` to record (kernel, side) of
    every launch; returns (records, undo).  The side is "pair view" for a
    distance head's launches: row 6 inside `symmetric_distances` and row 5
    in the backward of those row 6 calls (its autograd node, which is its
    backward's ctx); else "2D" where the launch's edge rows (edge_combine's
    pe, the others' first argument) are a 2D batch's (`rows_2d`, set by
    the caller), else "3D"."""
    base = importlib.import_module("infomax3d_tpu_torch.models.base")
    ec = importlib.import_module(
        "infomax3d_tpu_torch.ops.kernels.edge_combine")
    heads = [importlib.import_module(f"infomax3d_tpu_torch.models.{m}")
             for m in ("transformer", "net3d_vae")]
    state = {"pair": False, "nodes": set(), "rows_2d": set()}
    records, undo = [], []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    for name in NONE:
        mod = importlib.import_module(f"infomax3d_tpu_torch.ops.kernels.{name}")
        at = 2 if name == "edge_combine" else 0

        def rec(*a, _real=mod._launch, _name=name, _at=at, **kw):
            side = "pair view" if state["pair"] else \
                "2D" if a[_at].shape[0] in state["rows_2d"] else "3D"
            records.append((_name, side))
            return _real(*a, **kw)
        patch(mod, "_launch", rec)
    real_head = heads[0].symmetric_distances

    def head(*a, **kw):
        state["pair"] = True
        try:
            return real_head(*a, **kw)
        finally:
            state["pair"] = False
    for mod in heads:
        patch(mod, "symmetric_distances", head)
    real_combine = base.edge_combine

    def combine(*a, **kw):
        out = real_combine(*a, **kw)
        if state["pair"]:
            state["nodes"].add(out.grad_fn)
        return out
    patch(base, "edge_combine", combine)
    real_bwd = ec.EdgeCombine.backward

    def backward(ctx, ct):
        state["pair"] = ctx in state["nodes"]
        try:
            return real_bwd(ctx, ct)
        finally:
            state["pair"] = False
    patch(ec.EdgeCombine, "backward", staticmethod(backward))

    def restore():
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
    return records, state, restore


def _sides(records) -> dict:
    """Launch records as {side: {kernel: launches}}."""
    out = {}
    for name, side in records:
        d = out.setdefault(side, {})
        d[name] = d.get(name, 0) + 1
    return out


def _pair_times(tag: str, g, smi: str, D: int):
    """Rows 6 and 5 at width D on a pair view `g` (bf16): cold-L2 and warm
    device ms, the plain version's, row 5's nearest PyTorch call (two
    float32 `index_add_`), and the byte bound (each input read once, each
    output written once: rows 6 and 5 do 2 adds / 1 add per element)."""
    N, E = g.num_nodes, g.senders.shape[0]
    e_real = int(g.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(21)
    bf = torch.bfloat16
    hd, hs = (torch.randn(N, D, generator=gen, device="cuda").to(bf)
              for _ in range(2))
    pe, ct = (torch.randn(E, D, generator=gen, device="cuda").to(bf)
              for _ in range(2))
    ctf = ct.float()
    recv = g.receivers.long().clamp(max=N)
    send = g.senders.long().clamp(max=N)
    acc = torch.zeros(N + 1, D, device="cuda")

    def library_pair():
        acc.zero_().index_add_(0, recv, ctf)
        acc.zero_().index_add_(0, send, ctf)
    cases = {
        "edge_combine": (
            lambda: edge_combine(hd, hs, pe, g.receivers, g.senders),
            lambda: edge_combine_reference(hd, hs, pe, g.receivers,
                                           g.senders),
            2 * N * D * 2 + E * D * 2 + 2 * E * 4 + E * D * 2, 2.0 * E * D,
            None),
        "pair_segment_sum": (
            lambda: pair_segment_sum(ct, g.csr_row_ptr, g.csc_row_ptr,
                                     g.csc_perm),
            lambda: pair_segment_sum_reference(ct, g.csr_row_ptr,
                                               g.csc_row_ptr, g.csc_perm),
            e_real * D * 2 + 2 * (N + 1) * 4 + e_real * 4 + 2 * N * D * 2,
            2.0 * e_real * D, library_pair)}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for name, (kern, plain, nbytes, flops, lib) in cases.items():
        warm = device_ms(kern, iters=50, warmup=5)
        cold = device_ms(kern, iters=10, flush=flush)
        plain_ms = device_ms(plain, iters=3, warmup=1)
        lib_ms = device_ms(lib, iters=50, warmup=5) if lib else None
        bound_ms, bound_by = _bound(nbytes, flops)
        note = "two float32 index_add_" if lib else "no single PyTorch call"
        print(f"[baselines] {name} at D={D} ({tag}: N={N} E={E}, "
              f"{e_real} real, bf16): {cold:.5f} ms cold-L2 median, "
              f"{warm:.5f} ms warm; plain {plain_ms:.5f} ms; library "
              f"{_fmt(lib_ms)} ({note}); "
              f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes / 1e6:.3f} MB); "
              f"{bound_ms / cold:.3g} of the bound cold; {smi}")


def _write_baseline_caches(root: Path) -> Path:
    """Phase 19's QM9 and QMugs caches, for a run of this phase alone."""
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    write_synthetic_cache(str(root / "QM9" / "processed.npz"), **QM9_CACHE)
    write_synthetic_cache(str(root / "QMugs" / "processed.npz"),
                          **QMUGS_CACHE)
    return root


def _base_cli_expected(kind: str, run: dict) -> dict:
    """A CLI run's launches: its steps and eval forwards (the validation
    set after the epoch and again from the best checkpoint) from its
    split; contrastive batches drop a partial one."""
    from infomax3d_tpu_torch.cli.train import build_dataset, make_splits
    args = run["args"]
    tr, val, _ = make_splits(args, build_dataset(args))
    bs = args["batch_size"]
    full = args["collate_function"] == "contrastive_collate_ae"
    n = (lambda k: k // bs) if full else (lambda k: -(-k // bs))
    step = dict(NONE)
    for side in BASE_SIDES[kind].values():
        for name, v in side.items():
            step[name] += v
    return _expect(step, BASE_FWD[kind], n(len(tr)), 2 * n(len(val)))


def phase_baselines(smi: str, out_dir: Path, caches: Path = None) -> dict:
    """Phase 21: the distance-supervised and GraphCL pre-training baselines
    at full width: (a) `pre-train_distance_predictor_baseline.yml`, (b)
    `contrastive_training_Net3DAE.yml`, (c) `pre-train_graphCL_baseline.
    yml`.  Returns the main path's launches (the CLI runs) and the kernel
    checks' errors."""
    from infomax3d_tpu_torch.cli.train import build_dataset, make_splits
    errs = {}
    gen = torch.Generator(device="cuda").manual_seed(210)
    # 1-2: the float32 step on the card against the CPU; planted faults
    for kind in "abc":
        cpu = _base_one_step(kind, "cpu")
        card = _base_one_step(kind, "cuda")
        bad, r = _base_violations(card, cpu, cpu[3])
        print(f"[baselines] ({kind}) {BASE_NAMES[kind]}: float32 step, "
              f"batch {BASE_CHECK_BATCH[kind]}: loss card {card[0]:.6f} vs "
              f"CPU {cpu[0]:.6f}")
        _print_readings(f"({kind}) card vs CPU", r,
                        {s: STEP_TOL[False]["l2"] for s in r}, "baselines")
        _check(not bad, f"({kind}) float32 step card vs CPU: {bad}")
        fault, plant = BASE_FAULTS[kind]
        undo = plant()
        try:
            planted = _base_one_step(kind, "cuda")
        finally:
            undo()
        bad, _ = _base_violations(planted, cpu, cpu[3])
        print(f"[baselines] ({kind}) planted fault ({fault}): loss "
              f"{planted[0]:.6f}, {len(bad)} violations, e.g. {bad[:2]}")
        _check(bool(bad), f"({kind}) the step check passed a planted fault "
                          f"({fault})")
    # 4-5: launches per bf16 step by side, rows 6 and 5 on the pair views,
    # ms per step, graphs/s, peak memory
    for kind in "abc":
        bs = _base_args(kind, True)["batch_size"]
        step, prepared, sizes = _base_step(kind, True, "cuda", bs)
        records, state, undo = _launch_sides()
        state["rows_2d"].add(prepared[0].senders.shape[0])
        if kind == "c":
            state["rows_2d"].add(prepared[1].senders.shape[0])
        try:
            loss = float(step.step(*prepared))
        finally:
            undo()
        sides = _sides(records)
        print(f"[baselines] ({kind}) launches per bf16 step by side: "
              f"{sides}")
        _check(sides == BASE_SIDES[kind], f"({kind}) launches per step "
                                          f"{sides} != {BASE_SIDES[kind]}")
        if kind != "c":
            # (a)'s pair view, (b)'s 3D graph; the head's first layer runs
            # at width 1 in (a), at the projection's in (b)
            pairs = prepared[1]
            mp3 = _base_args(kind, True).get("model3d_parameters") or {}
            widths = (1,) if kind == "a" else (1, mp3["projection_dim"])
            tag = f"baselines ({kind}) pair view"
            _merge_errs(errs, {
                "edge_combine": _max_err(_hold_edge_combine(
                    tag, gen, pairs, widths)),
                "pair_segment_sum": _max_err(_hold_pair_segment_sum(
                    tag, gen, pairs, widths))})
            _pair_times(f"({kind}) pair view", pairs, smi, widths[-1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step.step(*prepared), iters=BASE_TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loss_after = float(step.step(*prepared))
        _check(np.isfinite(loss) and np.isfinite(loss_after),
               f"({kind}) non-finite bf16 loss")
        print(f"[baselines] ({kind}) bf16 step, batch {bs} ({sizes}): "
              f"{ms:.3f} ms per step (CUDA events over {BASE_TIMED_STEPS} "
              f"warm steps), {bs / ms * 1e3:.1f} graphs/s, peak "
              f"max_memory_allocated {peak:.3f} GiB; loss {loss:.5f} -> "
              f"{loss_after:.5f} after {BASE_TIMED_STEPS + 4} more steps; "
              f"{smi}")
        del step, prepared
    # 3, 6: the CLI in bf16 (the main path) and the fine-tune from (a)
    if caches is None:
        caches = _write_baseline_caches(out_dir / "baseline_caches")
    runs = {}
    _reset_counts()
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
        for kind in "abc":
            logdir = out_dir / f"baseline_{kind}"
            run = _data_run(BASE_CONFIGS[kind],
                            dict(BASE_CLI_COMMON, **BASE_CLI[kind]), logdir,
                            TRAINER_DEVICE)
            _check((run["dir"] / "best_checkpoint.pt").exists(),
                   f"({kind}) no checkpoint")
            recs = [json.loads(x) for x in open(run["dir"] /
                                                 "metrics.jsonl")]
            losses = [r[run["args"]["loss_func"]] for r in recs
                      if run["args"]["loss_func"] in r]
            _check(bool(losses) and all(np.isfinite(losses)),
                   f"({kind}) CLI losses {losses}")
            want = _base_cli_expected(kind, run)
            _check(run["launches"] == want,
                   f"({kind}) CLI launches {run['launches']} != {want}")
            path = {"edge_combine", "pna_stats", "pair_segment_sum",
                    "pna_stats_bwd"} | ({"csr_sum"} if kind == "b" else set())
            _check(all(run["launches"][n] > 0 for n in path),
                   f"({kind}) a kernel of the path did not launch")
            runs[kind] = run
            print(f"[baselines] ({kind}) CLI {BASE_CONFIGS[kind]} (bf16, "
                  f"{run['args']['dataset']} cache): {run['wall_s']:.1f} s, "
                  f"losses {losses}, result {run['result']}, launches "
                  f"{run['launches']}")
        tune = _data_run(TRAINER_TUNE, dict(
            BASE_CLI_COMMON, **BASE_TUNE,
            pretrain_checkpoint=str(runs["a"]["dir"] / "best_checkpoint.pt")),
            out_dir / "baseline_tune", TRAINER_DEVICE)
        launches = _counts()
        _, val_idx, _ = make_splits(tune["args"],
                                    build_dataset(tune["args"]))
    line = next(x for x in tune["text"].splitlines()
                if x.startswith("transferred "))
    _check(int(line.split()[1]) == BASE_TRANSFER,
           f"fine-tune from (a): {line} != {BASE_TRANSFER} (the JAX CLI's)")
    evals = 2 * -(-len(val_idx) // BASE_TUNE["batch_size"])
    want_tune = _expect(EXPECTED_STEP[True], EXPECTED[True], 1, evals)
    _check(tune["launches"] == want_tune,
           f"fine-tune launches {tune['launches']} != {want_tune}")
    print(f"[baselines] fine-tune tune_QM9_homo.yml from (a)'s checkpoint "
          f"(bf16, 1 step, {evals} eval forwards): {line.split(' from ')[0]}"
          f", the JAX CLI's {BASE_TRANSFER}; result {tune['result']}; "
          f"launches {tune['launches']}")
    print(f"[baselines] main-path launches (the CLI runs and the "
          f"fine-tune): {launches}")
    return {"launches": launches, "errs": errs}


# --------------------------------------- phase 22: the OT family's trainer

OT_FAMILY = {"a": "configs_clean/pre-train_Optimal_Transport_baseline.yml",
             "b": "configs/ot_gin.yml", "c": "configs/ot_geomol_gnn.yml"}
OT_FAMILY_NAMES = {"a": "PNAGNNRandomEdgeUpdate 50x3",
                   "b": "virtual-node GIN 5x300, dropout 0.5",
                   "c": "GeomolGNNOGBFeat 100x5, two GNNs"}
# the check batches: 16 molecules with 10 conformers each, QM9-size for
# (a) and (b) (phase 14's OT batch), drug-size for (c)
OT_FAMILY_DATA = {"a": OT_DATA, "b": OT_DATA,
                  "c": {"seed": 0, "n_min": 20, "n_max": 50}}
OT_FAMILY_LR = 1e-3
GIN_OT_DEPTH, GIN_OT_WIDTH = 5, 300
# launches per step: (a) as phase 15's step, and with `ignore_neighbors`
# gnn2 runs forward in both passes but reaches no term of the cost, so
# only gnn's gathers run backward; (b) each GIN layer sums its messages
# (row 7) in both passes and its sender gather's backward is row 4; (c)
# the GeoMol MPNN's gathers and sums are plain PyTorch.  An eval batch
# (validation) runs the cost pass and the loss pass forward: the forward
# launches of a step.
GIN_OT_PASS = 2 * OT_CONFS * GIN_OT_DEPTH
OT_FAMILY_STEP = {
    "a": EXPECTED_OT_STEP,
    "a local": dict(NONE, multi_reduce=2 * OT_PASS,
                    snd_segment_sum=OT_PASS // 2,
                    csr_segment_sum=OT_PASS // 2),
    "b": dict(NONE, csr_sum=2 * GIN_OT_PASS, snd_segment_sum=GIN_OT_PASS),
    "c": dict(NONE)}
OT_FAMILY_EVAL = {"a": dict(NONE, multi_reduce=2 * OT_PASS),
                  "b": dict(NONE, csr_sum=2 * GIN_OT_PASS), "c": dict(NONE)}
# GIN leaves whose gradient is exactly zero (a bias feeding a BatchNorm):
# the convolutions' two Linears' and the virtual node's first Linear's
GIN_ZERO = ZERO_GRADIENT + tuple(f"vn_mlp_{i}_0.bias"
                                 for i in range(GIN_OT_DEPTH - 1))
# The card against the CPU, one float32 trainer step from the same weights,
# batch, draws and dropout masks, as phase 15 holds its step, with two
# witnesses, the CPU step from weights perturbed by OT_WITNESS_REL (two
# seeds): the cost, the loss and the gradient's L2 within
# OT_WITNESS_FACTOR times their witnesses' or OT_TOL, whichever is larger;
# each gradient leaf within OT_WITNESS_FACTOR times the larger of its two
# witness readings, or OT_TOL["leaf"], or the gradient's L2 bound, the
# largest (a leaf's error is one draw of what the witnesses sample: at (b)
# one call in three read three leaves at 1.07 to 1.72 times four times
# their witnesses, 0.0088 to 0.014, while its gradient's L2 read 0.00118
# of a bound of 0.0165); the running statistics within STEP_TOL's float32
# bound; and Adam's update of the weights (the change over lr) within
# OT_WITNESS_FACTOR times its witnesses' in L2, at least OT_UPDATE_L2 (the
# first Adam step is lr * g / (|g| + eps): a rounding-noise gradient entry
# moves by lr with either sign on each side).  The GIN of (b) is the most
# sensitive: 8 float32 ulps on its weights move its cost by 6.9e-5 and its
# gradient by 1.8e-3 in L2 (on the CPU), while the CPU's own
# summation orders (one thread against eight) agree to 1e-7 and 5e-7.
OT_UPDATE_L2 = 1e-3
# with `ignore_neighbors` the pair statistics reach no term of the cost:
# these parameters get a zero gradient
OT_LOCAL_IDLE = ("model.gnn2.", "model.gnn2_output_mlp.", "model.h_mol_mlp.",
                 "model.alpha_mlp.", "model.c_mlp.")
# the CLI runs: synthetic caches of 160 molecules with 10 conformers (a
# model pool of 128, test 8, validation 24); 48 of the pool (3 steps of 16
# an epoch) for 2 epochs, (a) with its first epoch local-only; the
# fine-tune's OT run takes 1 epoch of 2 steps, the fine-tune 1 epoch on a
# 300-molecule ogbg-molesol-shaped cache (scaffold split) and batch 32
OT_FAMILY_CACHES = {
    "file_loader_qm9": dict(num=160, num_conformers=10, seed=0, n_min=10,
                            n_max=26),
    "file_loader_drugs": dict(num=160, num_conformers=10, seed=1, n_min=20,
                              n_max=50),
    "ot_pyg_geom_qm9": dict(num=40, num_conformers=10, seed=2, n_min=10,
                            n_max=26),
    "ogbg_molesol": dict(num=300, num_targets=1, seed=3, split="scaffold")}
OT_FAMILY_CLI = {"num_epochs": 2, "num_train": 48, "batch_size": 16,
                 "log_iterations": 1, "use_tensorboard": False,
                 "dataset_params": {}}
OT_FAMILY_LOCAL = {"a": {"num_epochs_local_only": 2}}
OT_TUNE_PRE = "configs/ot_pyg_in_memory.yml"
OT_TUNE = "configs/tune_from_ot_pna.yml"
OT_TUNE_PRE_RUN = {"num_epochs": 1, "num_train": 8, "batch_size": 4,
                   "log_iterations": 1, "use_tensorboard": False,
                   "dataset_params": {}}
OT_TUNE_RUN = {"num_epochs": 1, "batch_size": 32, "log_iterations": 1,
               "use_tensorboard": False, "dataset_params": {}}
# the tensors the JAX CLI transfers into the fine-tune's node_gnn
# (GeomolGNNOGBFeat 50x3, tests/test_torch_port_ot_trainer.py): 12
# encoder tables, three 3-Linear MLPs (node_init, edge_init, the edge
# model's), the edge model's edge Linear and two projections, the node
# model's two MLPs and the two epsilons
OT_TUNE_TRANSFER = 12 + 3 * 2 * 3 + 4 + 2 * 3 * 2 + 2
OT_FAMILY_TIMED = 5


def _family_mp(kind: str) -> dict:
    from infomax3d_tpu_torch.cli.config import load_config
    return load_config(OT_FAMILY[kind], {})["model_parameters"]


def _family_batch(kind: str, dev):
    return ot_batch(OT_BATCH, OT_CONFS, device=dev, **OT_FAMILY_DATA[kind])


def _family_step(kind: str, dev, ignore: bool = False) -> OTStep:
    mp = _family_mp(kind)
    params, stats = init_jax_variables(mp, 0, "OptimalTransportModel")
    step = OTStep(mp, {"params": params, "batch_stats": stats},
                  torch.device(dev), {"lr": OT_FAMILY_LR})
    step.ignore_neighbors = ignore
    return step


def _family_one_step(kind: str, dev: str, ignore: bool, noise=None,
                     plans=None, perturb: float = 0.0, perturb_seed: int = 7):
    """One trainer step of `kind` from the seeded weights (scaled by 1 +
    perturb U(-1, 1) first, U from `perturb_seed`) on `dev`: the cost pass (its dropout source
    drawing fresh, unused in eval mode), the plans (given, or the step's
    own), the gradient pass and Adam.  `noise` is (draws, masks) to
    replay; without it the draws and masks are drawn on the CPU and
    returned.  Returns (cost, plans, (loss, gradients and statistics), the
    update over lr per parameter, noise)."""
    step = _family_step(kind, dev, ignore)
    batch, _ = _family_batch(kind, dev)
    if perturb:
        gen = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for p in step.model.parameters():
                u = torch.rand(p.shape, generator=gen) * 2 - 1
                p.mul_(1 + perturb * u.to(p.device))
    spare = GeneratorNoise(torch.Generator(dev).manual_seed(5))
    if noise is None:
        rec = GeneratorNoise(torch.Generator().manual_seed(99))
        cost = step.cost(batch, rec)
        masks = GeneratorNoise(torch.Generator().manual_seed(98))
        grad_noise = ReplayNoise(rec.draws, fresh=masks)
    else:
        draws, mask_draws = ([(k, t.to(dev)) for k, t in d] for d in noise)
        cost = step.cost(batch, ReplayNoise(draws, fresh=spare))
        grad_noise = ReplayNoise(draws, fresh=ReplayNoise(mask_draws))
    if plans is None:
        plans = step.plans(cost, batch).cpu()
    before = {n: p.detach().clone() for n, p in
              step.model.named_parameters()}
    out = _measure_step(step, {"model": step.model},
                        (batch, grad_noise, plans.to(dev)))
    step.optimizer.step()
    update = {f"model.{n}": ((p.detach() - before[n]) / OT_FAMILY_LR).cpu()
              for n, p in step.model.named_parameters()}
    if noise is None:
        noise = (rec.draws, masks.draws)
    return cost.cpu(), plans, out, update, noise


def _update_l2(one: dict, ref: dict) -> float:
    a = torch.cat([one[k].flatten() for k in ref])
    b = torch.cat([ref[k].flatten() for k in ref])
    return float((a - b).norm() / b.norm())


def _family_readings(kind: str, one, ref, ignore: bool) -> tuple:
    """A `_family_one_step` result `one` against the CPU's `ref`: (the
    cost's, loss's and update's relative errors, `_readings` of the
    gradients, what breaks the rules that need no bound).  With `ignore`,
    the gradient of `OT_LOCAL_IDLE` must be exactly zero on both sides and
    stays out of the readings."""
    cost, _, (loss, grads), upd, _ = one
    rcost, _, (rloss, rgrads), rupd, _ = ref
    idle = [k for k in rgrads if ignore and k.startswith(OT_LOCAL_IDLE)
            and "running" not in k]
    bad = [f"{k}: nonzero gradient with ignore_neighbors" for k in idle
           if grads[k] is None or bool(grads[k].any()) or bool(
               rgrads[k].any())]
    real = rcost < 1e8
    if not torch.equal(cost >= 1e8, ~real):
        bad.append("masked cost entries differ")
    c = {"cost": float((cost - rcost)[real].abs().max()
                       / rcost[real].abs().max()),
         "loss": abs(loss - rloss) / abs(rloss),
         "update": _update_l2(upd, rupd)}
    r = _readings({k: v for k, v in grads.items() if k not in idle},
                  {k: v for k, v in rgrads.items() if k not in idle},
                  ("model",), GIN_ZERO if kind == "b" else ())
    return c, r, bad


def _family_check(kind: str, one, ref, witnesses, ignore: bool) -> tuple:
    """`one` (the card) against `ref` (the CPU) under the bounds the
    `witnesses` set: (readings, gradient readings, leaf bounds, other
    bounds, violations)."""
    c, r, bad = _family_readings(kind, one, ref, ignore)
    ws = [_family_readings(kind, w, ref, ignore)[:2] for w in witnesses]
    floor = dict(OT_TOL, update=OT_UPDATE_L2)
    tol = {k: max(floor[k], OT_WITNESS_FACTOR * max(w[0][k] for w in ws))
           for k in c}
    tol["l2"] = max(OT_TOL["l2"], OT_WITNESS_FACTOR * max(
        w[1]["model"]["l2"] for w in ws))
    leaf_tol = {k: max(OT_TOL["leaf"], tol["l2"], OT_WITNESS_FACTOR * max(
        w[1]["model"]["leaves"][k] for w in ws))
        for k in r["model"]["leaves"]}
    bad += [f"{k} {c[k]:.3g} > {tol[k]:.3g}" for k in c if c[k] > tol[k]]
    bad += _violations(r, dict(OT_TOL, zero=STEP_TOL[False]["zero"],
                               stats=STEP_TOL[False]["stats"]),
                       {"model": tol["l2"]}, leaf_tol)
    return c, r, leaf_tol, tol, bad


def _kept_dihedrals():
    """(a)'s planted fault: the cost keeps its dihedral and three-hop
    terms while `ignore_neighbors` is on.  Returns the undo."""
    from infomax3d_tpu_torch.models.optimal_transport import \
        OptimalTransportModel
    real = OptimalTransportModel.molecule_loss_matrix
    OptimalTransportModel.molecule_loss_matrix = \
        lambda self, g, ex, t, m, ignore_neighbors=False: real(
            self, g, ex, t, m, False)
    return lambda: setattr(OptimalTransportModel, "molecule_loss_matrix",
                           real)


def _training_mode_cost():
    """(b)'s planted fault: the cost pass runs in training mode (batch
    statistics, their running averages updated, dropout).  Returns the
    undo."""
    real = OTStep.cost

    def cost(self, batch, noise):
        with torch.no_grad():
            return self.model(batch, noise,
                              ignore_neighbors=self.ignore_neighbors,
                              return_cost_matrix=True)
    OTStep.cost = cost
    return lambda: setattr(OTStep, "cost", real)


def _gnn2_reads_gnn():
    """(c)'s planted fault: the second backbone runs with the first one's
    weights.  Returns the undo."""
    from infomax3d_tpu_torch.models.optimal_transport import \
        OptimalTransportModel
    real = OptimalTransportModel.embed

    def embed(self, g, noise):
        gnn2 = self.gnn2
        self.gnn2 = self.gnn
        try:
            return real(self, g, noise)
        finally:
            self.gnn2 = gnn2
    OptimalTransportModel.embed = embed
    return lambda: setattr(OptimalTransportModel, "embed", real)


OT_FAMILY_FAULTS = {
    ("a", True): ("the dihedral terms kept with ignore_neighbors",
                  _kept_dihedrals),
    ("b", False): ("the cost pass in training mode", _training_mode_cost),
    ("c", False): ("gnn2 reading gnn's weights", _gnn2_reads_gnn)}


def _family_checks():
    """Items 1 and 2: each configuration's step on the card against the
    CPU, and the planted faults."""
    for (kind, ignore) in (("a", False), ("a", True), ("b", False),
                           ("c", False)):
        tag = f"({kind}){' ignore_neighbors' if ignore else ''}"
        ref = _family_one_step(kind, "cpu", ignore)
        noise, plans = ref[4], ref[1]
        witnesses = [_family_one_step(kind, "cpu", ignore, noise, plans,
                                      OT_WITNESS_REL, seed) for seed in (7, 8)]
        card = _family_one_step(kind, "cuda", ignore, noise, plans)
        c, r, leaf_tol, tol, bad = _family_check(kind, card, ref, witnesses,
                                                 ignore)
        print(f"[ot-family] {tag} {OT_FAMILY_NAMES[kind]}: float32 step "
              f"card vs CPU: loss {card[2][0]:.6f} vs {ref[2][0]:.6f}; "
              + ", ".join(f"{k} {v:.3g} (bound {tol[k]:.3g})"
                          for k, v in c.items())
              + f"; {len(noise[1])} dropout masks replayed")
        _print_readings(f"{tag} card vs CPU", r, {"model": tol["l2"]},
                        "ot-family")
        _print_ot_leaves(f"{tag} card vs CPU", r, leaf_tol)
        _check(not bad, f"{tag} card vs CPU: {bad}")
        if (kind, ignore) not in OT_FAMILY_FAULTS:
            continue
        fault, plant = OT_FAMILY_FAULTS[(kind, ignore)]
        undo = plant()
        try:
            planted = _family_one_step(kind, "cuda", ignore, noise, plans)
        finally:
            undo()
        c, _, _, _, bad = _family_check(kind, planted, ref, witnesses,
                                        ignore)
        print(f"[ot-family] {tag} planted fault ({fault}): "
              + ", ".join(f"{k} {v:.3g}" for k, v in c.items())
              + f"; {len(bad)} violations, e.g. {bad[:3]}")
        _check(bool(bad), f"{tag}: the step check passed a planted fault "
                          f"({fault})")


def _family_kernels(ob) -> dict:
    """Item 3: rows 7 and 4 bit for bit at (b)'s batch at D = 300 (the GIN
    width), row 1 at (a)'s (D = 50)."""
    gen = torch.Generator(device="cuda").manual_seed(220)
    gr = ob.graph
    E = gr.senders.shape[0]
    errs = {"csr_sum": _max_err(_hold_csr_sum("ot-family (b)", gen, gr,
                                              (GIN_OT_WIDTH,)))}
    _merge_errs(errs, _hold_walks(
        "ot-family", gen, [("(a)'s batch", gr.csr_row_ptr, gr.max_deg, E,
                            (OT_WIDTH,))],
        [("(b)'s batch", gr.csc_row_ptr, gr.csc_perm, E, (GIN_OT_WIDTH,))]))
    return errs


def _family_row_times(ob, smi: str):
    """Item 7: rows 7 and 4 at (b)'s shape (float32, D = 300), cold-L2 and
    warm, beside their byte bounds."""
    gr = ob.graph
    N, E, D = gr.num_nodes, gr.senders.shape[0], GIN_OT_WIDTH
    e_real = int(gr.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(221)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    x = torch.randn(E, D, generator=gen, device="cuda")
    calls = {"csr_sum (row 7)": (lambda: csr_sum(x, gr.csr_row_ptr),
                                 (N + 1) * 4),
             "snd_segment_sum (row 4)": (
                 lambda: snd_segment_sum(x, gr.csc_row_ptr, gr.csc_perm),
                 (N + 1) * 4 + e_real * 4)}
    for name, (fn, index_bytes) in calls.items():
        nbytes = e_real * D * 4 + index_bytes + N * D * 4
        bound_ms, by = _bound(nbytes, float(e_real * D))
        cold = device_ms(fn, iters=20, flush=flush)
        warm = device_ms(fn, iters=100, warmup=10)
        print(f"[ot-family] {name} at (b)'s shape (N={N}, real E={e_real}, "
              f"D={D}, float32): {cold:.5f} ms cold-L2 median, {warm:.5f} "
              f"ms warm; bound {bound_ms:.5f} ms by {by} ({nbytes / 1e6:.3f}"
              f" MB), {bound_ms / cold:.1%} of it cold; {smi}")


def _family_timed(smi: str):
    """Items 5 and 7: each configuration's launches per step (exact),
    then ms per step, graphs/s, peak memory, the host EMD per step and
    kernels per step."""
    from torch.profiler import ProfilerActivity, profile
    for kind, ignore in (("a", True), ("a", False), ("b", False),
                         ("c", False)):
        tag = "a local" if ignore else kind
        step = _family_step(kind, "cuda", ignore)
        batch, sizes = _family_batch(kind, "cuda")
        seeds = iter(range(4000, 5000))

        def one():
            return step.step(batch, torch.Generator("cuda").manual_seed(
                next(seeds)))
        _reset_counts()
        loss = float(one())
        per = _counts()
        _check(per == OT_FAMILY_STEP[tag] and np.isfinite(loss),
               f"({tag}) launches per step {per} != {OT_FAMILY_STEP[tag]}")
        print(f"[ot-family] ({tag}) launches per step (exact): "
              f"{ {n: c for n, c in per.items() if c} }")
        if ignore:
            continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step.timing["host_emd"] = 0.0
        ms = cuda_ms(one, iters=OT_FAMILY_TIMED, warmup=1)
        emd_ms = step.timing["host_emd"] * 1e3 / (OT_FAMILY_TIMED + 1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        by_name = _profile_kernels(prof)
        kernels = sum(c for _, c in by_name.values())
        busy = sum(us for us, _ in by_name.values()) / 1e3
        print(f"[ot-family] ({kind}) {OT_FAMILY_NAMES[kind]}: {ms:.3f} ms "
              f"per step (CUDA events over {OT_FAMILY_TIMED} warm steps), "
              f"{OT_BATCH / ms * 1e3:.2f} graphs/s, host EMD {emd_ms:.3f} "
              f"ms per step, peak max_memory_allocated {peak:.3f} GiB, "
              f"{kernels} kernels per step (busy {busy:.3f} ms, profiled "
              f"step), batch {sizes}; {smi}")
        del step, batch


def _family_cli_expected(run: dict, kind: str, steps: int) -> dict:
    """A CLI run's launches: its steps (the first epoch local-only where
    the config says so) and its eval batches (a validation per epoch, the
    best checkpoint's, the test set's)."""
    from infomax3d_tpu_torch.cli.train import build_dataset, make_splits
    args = run["args"]
    _, val, test = make_splits(args, build_dataset(args))
    bs = args["batch_size"]
    evals = (args["num_epochs"] + 1) * -(-len(val) // bs) + \
        (-(-len(test) // bs) if args["eval_on_test"] and len(test) else 0)
    local = args.get("num_epochs_local_only", 1) - 1
    per_epoch = steps // args["num_epochs"]
    step = OT_FAMILY_STEP[kind]
    local_step = OT_FAMILY_STEP.get(f"{kind} local", step)
    out = {n: step[n] * (steps - local * per_epoch)
           + local_step[n] * local * per_epoch
           + OT_FAMILY_EVAL[kind][n] * evals for n in NONE}
    return out


def _family_cli(out_dir: Path, caches: Path) -> dict:
    """Items 4 and 6: (a), (b), (c) through `cli.train.train` on the
    caches (2 epochs of 3 steps, the learning rate printed at each step),
    then the fine-tune from an OT checkpoint of `ot_pyg_in_memory.yml`'s
    model.  Returns the launches (the main path)."""
    from infomax3d_tpu_torch.cli.train import build_dataset, make_splits
    lrs = []
    real_step = OTStep.step

    def step_with_lr(self, batch, generator):
        lrs.append([g["lr"] for g in self.optimizer.param_groups])
        return real_step(self, batch, generator)
    OTStep.step = step_with_lr
    _reset_counts()
    try:
        with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
            for kind, config in OT_FAMILY.items():
                lrs.clear()
                run = _data_run(config, dict(
                    OT_FAMILY_CLI, **OT_FAMILY_LOCAL.get(kind, {})),
                    out_dir / f"ot_family_{kind}", TRAINER_DEVICE)
                _check((run["dir"] / "best_checkpoint.pt").exists(),
                       f"({kind}) no checkpoint")
                recs = [json.loads(x) for x in open(run["dir"] /
                                                     "metrics.jsonl")]
                train = [r["MSELoss"] for r in recs if r["split"] == "train"]
                val = [r["MSELoss"] for r in recs if r["split"] == "val"]
                steps = len(train)
                _check(steps == 6 and len(val) == 2 and
                       all(np.isfinite(train + val)),
                       f"({kind}) CLI losses {train}, validation {val}")
                want = _family_cli_expected(run, kind, steps)
                _check(run["launches"] == want,
                       f"({kind}) CLI launches {run['launches']} != {want}")
                timing = json.load(open(run["dir"] / "timing.json"))
                print(f"[ot-family] ({kind}) CLI {config} ({run['args']['dataset']} "
                      f"cache, 2 epochs of 3 steps): {run['wall_s']:.1f} s, "
                      f"train losses {[round(x, 4) for x in train]}, "
                      f"validation {[round(x, 4) for x in val]}, lr per "
                      f"step {[x[0] for x in lrs]}, host EMD "
                      f"{timing['host_emd']:.3f} s, step ms "
                      f"{[round(x, 1) for x in timing['step_ms']]}; "
                      f"launches {run['launches']}")
            pre = _data_run(OT_TUNE_PRE, OT_TUNE_PRE_RUN,
                            out_dir / "ot_family_tune_pre", TRAINER_DEVICE)
            tune = _data_run(OT_TUNE, dict(
                OT_TUNE_RUN, pretrain_checkpoint=str(
                    pre["dir"] / "best_checkpoint.pt")),
                out_dir / "ot_family_tune", TRAINER_DEVICE)
            _, val_idx, _ = make_splits(tune["args"],
                                        build_dataset(tune["args"]))
    finally:
        OTStep.step = real_step
    launches = _counts()
    line = next(x for x in tune["text"].splitlines()
                if x.startswith("transferred "))
    _check(int(line.split()[1]) == OT_TUNE_TRANSFER,
           f"fine-tune: {line} != {OT_TUNE_TRANSFER} (the JAX CLI's)")
    recs = [json.loads(x) for x in open(tune["dir"] / "metrics.jsonl")]
    steps = [r for r in recs if r["split"] == "train"]
    _check(len(steps) > 0 and (tune["dir"] / "best_checkpoint.pt").exists(),
           "fine-tune: no steps or no checkpoint")
    print(f"[ot-family] (d) {OT_TUNE_PRE} 1 epoch of "
          f"{OT_TUNE_PRE_RUN['num_train'] // OT_TUNE_PRE_RUN['batch_size']} "
          f"steps ({pre['wall_s']:.1f} s), then {OT_TUNE} from its "
          f"checkpoint: {line.split(' from ')[0]}, the JAX CLI's "
          f"{OT_TUNE_TRANSFER}; {len(steps)} steps, {len(val_idx)} "
          f"validation molecules, result {tune['result']} "
          f"({tune['wall_s']:.1f} s)")
    print(f"[ot-family] main-path launches (the CLI runs): {launches}")
    return launches


def _write_family_caches(root: Path) -> Path:
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    for name, kw in OT_FAMILY_CACHES.items():
        write_synthetic_cache(str(root / name / "processed.npz"), **kw)
    return root


def phase_ot_family(smi: str, out_dir: Path) -> dict:
    """Phase 22: the OT family through its trainer at the configs' widths:
    (a) `pre-train_Optimal_Transport_baseline.yml`, (b) `ot_gin.yml`, (c)
    `ot_geomol_gnn.yml`, and (d) `tune_from_ot_pna.yml` from an OT
    checkpoint.  Returns the main path's launches (the CLI runs) and the
    kernel checks' errors."""
    t = [time.perf_counter()]
    ob, _ = _family_batch("a", "cuda")
    errs = _family_kernels(ob)
    t.append(time.perf_counter())
    _family_checks()
    t.append(time.perf_counter())
    _family_timed(smi)
    _family_row_times(ob, smi)
    t.append(time.perf_counter())
    caches = _write_family_caches(out_dir / "ot_family_caches")
    launches = _family_cli(out_dir, caches)
    t.append(time.perf_counter())
    print("[ot-family] seconds: " + ", ".join(
        f"{k} {b - a:.1f}" for k, a, b in zip(
            ("kernel checks", "step checks", "timings", "CLI runs"),
            t, t[1:])))
    return {"launches": launches, "errs": errs}


# ------------------------ phase 23: the GIN's options and the transformers

SLICE16 = {"a": "configs/gin_ogb_2.yml", "b": "configs/gin_random.yml",
           "c": "configs/pnatransformer.yml",
           "d": "configs/pnatransformer_ogbg.yml",
           "e": "configs/transformer.yml", "f": "configs/transformer_ogbg.yml"}
SLICE16_SIMPLE = "configs/pnatransformersimple_ogbg.yml"
SLICE16_NAMES = {"a": "OGBGNN GIN 5x300, dropout 0.5",
                 "b": "OGBGNNRandom 5x300, virtual node, dropout 0.5",
                 "c": "PNATransformer 200x7, 10 heads",
                 "d": "PNATransformer 512x6, 32 heads, dropout 0.1",
                 "e": "TransformerPlain 512x6, 32 heads, dropout 0.1",
                 "f": "TransformerPlain 512x6 on molhiv",
                 "gcn": "OGBGNN GCN 5x300, attention pooling, dropout 0.5"}
# (a)'s model with GCN convolutions and attention pooling: options no
# config sets, held on the card once because they run rows 7 and 4 through
# the GCN's degree normalisation
SLICE16_GCN = {"gnn_type": "gcn", "graph_pooling": "attention"}
# the batches: molhiv-like molecules (10 to 41 atoms, so (d)'s dense
# exchange spills past its 40 slots) for the OGB configs, QM9-size ones
# for (c) and (e); (e) and (f) on the dense batch
_MOLHIV = {"seed": 0, "n_min": 10, "n_max": 41}
_QM9 = {"seed": 0, "n_min": 10, "n_max": 26}
SLICE16_DATA = {"a": _MOLHIV, "b": _MOLHIV, "gcn": _MOLHIV, "c": _QM9,
                "d": _MOLHIV, "e": _QM9, "f": _MOLHIV}
# the card-against-CPU checks take 31 graphs: an odd count, so that the
# L1 loss's bias gradient (the mean of the residuals' signs) cannot vanish
SLICE16_CHECK = 31
SLICE16_TIMED = 10


def _s16_launches(kind: str, step: bool) -> dict:
    """Launches per training step (`step`) or eval forward of `kind`: each
    GIN or GCN layer sums its messages (row 7) and, in a step, sums its
    sender gather's cotangents (row 4); each PNA layer of the bf16
    PNATransformer runs the edge combine (row 6) and the statistics (row
    2), and in a step their backwards (rows 5 and 8); the dense attention
    and TransformerPlain run no kernel of the port."""
    mp = _s16_args(kind, True)["model_parameters"]
    if kind in ("e", "f"):
        return dict(NONE)
    if kind in ("c", "d"):
        n = mp["propagation_depth"]
        return dict(NONE, edge_combine=n, pna_stats=n,
                    **({"pair_segment_sum": n, "pna_stats_bwd": n}
                       if step else {}))
    n = mp["num_layers"]
    return dict(NONE, csr_sum=n, **({"snd_segment_sum": n} if step else {}))


def _s16_args(kind: str, bf16: bool) -> dict:
    """The config's step as `build_supervised_step` takes it (Adam at the
    config's lr; the CLI runs the config's own optimizer)."""
    from infomax3d_tpu_torch.cli.config import load_config
    a = load_config(SLICE16["a" if kind == "gcn" else kind], {})
    mp = dict(a["model_parameters"])
    if kind == "gcn":
        mp.update(SLICE16_GCN)
    return {"model_type": a["model_type"], "model_parameters": mp,
            "loss_func": a["loss_func"],
            "optimizer_params": {"lr": a["optimizer_params"]["lr"]},
            "batch_size": a["batch_size"], "bf16_compute": bf16, "seed": 0,
            "collate_function": a["collate_function"],
            "max_nodes": a["max_nodes"]}


def _s16_batch(kind: str, dev, batch_size: int = None):
    a = _s16_args(kind, False)
    return labelled_batch(batch_size or a["batch_size"],
                          a["model_parameters"].get("target_dim", 1),
                          device=dev, dense=kind in ("e", "f"),
                          max_nodes=a["max_nodes"], **SLICE16_DATA[kind])


def _s16_masks(kind: str, g) -> list:
    """The dropout masks of one training forward of `kind` on `g`, drawn
    on the CPU (the step checks replay them on both sides)."""
    step = build_supervised_step(_s16_args(kind, False), torch.device("cpu"))
    rec = GeneratorNoise(torch.Generator().manual_seed(97))
    with torch.no_grad():
        step.loss(step.prepare(g), noise=MasksOnly(rec))
    return rec.draws


def _s16_one_step(kind: str, g, masks: list, bf16: bool, dev: str):
    """`_measure_step` of one step of `kind` from the seeded weights, the
    masks replayed."""
    step = build_supervised_step(_s16_args(kind, bf16), torch.device(dev))
    noise = MasksOnly(ReplayNoise([(k, t.to(dev)) for k, t in masks]))
    return _measure_step(step, {"model": step.model}, (step.prepare(g),),
                         noise=noise)


def _patched(module: str, name: str, value):
    """Set `module.name` to `value`; returns the undo."""
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    setattr(mod, name, value)
    return lambda: setattr(mod, name, real)


def _pooled_message_dropped():
    """(b)'s planted fault: the virtual node's pooled message (each graph's
    sum of its nodes) dropped, the virtual node passed on alone."""
    return _patched("infomax3d_tpu_torch.models.random_variants",
                    "segment_sum", lambda data, ids, n: data.new_zeros(
                        (n,) + tuple(data.shape[1:])))


def _unscaled_dropout():
    """The dropout fault: the masks applied without the 1 / keep_prob
    scale, in every module that drops."""
    def unscaled(x, rate, source, training):
        if not training or rate == 0.0:
            return x
        keep = source.bernoulli(1.0 - rate, x.shape).to(x.device)
        return torch.where(keep, x, torch.zeros_like(x))
    undos = [_patched(f"infomax3d_tpu_torch.models.{m}", n, unscaled)
             for m, n in (("gin", "dropout"), ("random_variants", "dropout"),
                          ("base", "drop"), ("attention", "drop"))]
    return lambda: [u() for u in undos]


def _pna_masks_unapplied():
    """(d)'s planted fault: the PNA layers' MLPs draw their masks (the
    stream keeps its order) and pass their input on unmasked, so the
    masks never reach the edge-combine output before the folded
    BatchNorm."""
    from infomax3d_tpu_torch.models import base

    def unmasked(x, rate, source, training):
        if training and rate > 0.0:
            source.bernoulli(1.0 - rate, x.shape)
        return x
    return _patched(base.__name__, "drop", unmasked)


def _wrong_slots():
    """(c)'s planted fault: `dense_to_flat` reads each node's next slot."""
    from infomax3d_tpu_torch.models import transformer as tm

    def shifted(dense, g):
        G, M, D = dense.shape
        flat = (g.node_graph.long() * M + g.node_pos.long() + 1).clamp(
            0, G * M - 1)
        return dense.reshape(G * M, D)[flat]
    return _patched(tm.__name__, "dense_to_flat", shifted)


def _key_mask_ignored():
    """(c)'s other planted fault: the attention's key mask ignored (every
    slot attended, the empty ones too)."""
    from infomax3d_tpu_torch.models import attention as am
    real = am.masked_softmax
    return _patched(am.__name__, "masked_softmax",
                    lambda scores, mask, dim=-1: real(
                        scores, torch.ones_like(mask), dim))


def _pe_pair_swapped():
    """(e)'s planted fault: each (eigenvalue, eigenvector entry) pair of the
    Laplacian PE read in the wrong order.  (The PE mask is true on each real
    atom's k entries, the NaN-padded frequencies included, as the JAX
    collate marks them; ignoring it would change only the padding atoms'
    rows, which nothing reads.)"""
    from infomax3d_tpu_torch.models.transformer import TransformerGNN
    real = TransformerGNN.forward

    def forward(self, g, noise=None):
        return real(self, dataclasses.replace(g, lap_pe=g.lap_pe.flip(-1)),
                    noise)
    TransformerGNN.forward = forward
    return lambda: setattr(TransformerGNN, "forward", real)


def _receiver_degree_dropped():
    """The GCN path's planted fault: the edge normalisation taken from the
    sender's degree alone (norm_s ** 2 where it is norm_s * norm_r).  On a
    bond graph every node's in-degree equals its out-degree (each bond runs
    both ways), so a normalisation taken from in-degrees would compute the
    same numbers and no check could see it."""
    from infomax3d_tpu_torch.models import gin

    def forward(self, g, h):
        x = self.linear(h)
        degs = gin.out_degree(g, h.shape[0]) + 1.0
        enorm = gin.take_clipped(degs[:, None] ** -0.5, g.senders) ** 2
        msg = enorm * torch.relu(gin.gather_src(g, x)
                                 + self.bond_encoder(g.edge_feat))
        return gin.edge_aggregate(g, msg, "sum") + torch.relu(
            x + self.root_emb.weight) / degs[:, None]
    real = gin.GCNConv.forward
    gin.GCNConv.forward = forward
    return lambda: setattr(gin.GCNConv, "forward", real)


SLICE16_FAULTS = {
    "b": {"the virtual node's pooled message dropped":
          _pooled_message_dropped,
          "the dropout masks without their 1 / keep_prob scale":
          _unscaled_dropout},
    "c": {"dense_to_flat reading the next slot": _wrong_slots,
          "the attention key mask ignored": _key_mask_ignored},
    "d": {"the PNA layers' masks drawn and not applied":
          _pna_masks_unapplied,
          "the dropout masks without their 1 / keep_prob scale":
          _unscaled_dropout},
    "e": {"the Laplacian PE's (eigenvalue, entry) pairs swapped":
          _pe_pair_swapped},
    "gcn": {"the edge normalisation from the sender's degree alone":
            _receiver_degree_dropped}}
# the zero-gradient leaves: a bias feeding a BatchNorm ((b)'s virtual
# node's first Linears, the attention gate's first Linear) and the gate's
# last bias (the softmax within each graph removes it); none in (d), whose
# dropout masks fall between each PNA Linear and its BatchNorm, so the
# normalization no longer removes the bias
SLICE16_ZERO = {"b": GIN_ZERO, "c": ZERO_GRADIENT, "d": (),
                "e": ZERO_GRADIENT,
                "gcn": ZERO_GRADIENT + ("pool.gate_nn.0.bias",
                                        "pool.gate_nn.3.bias")}


def _s16_checks():
    """Items 2 and 3: one float32 and one bf16 step of (b), (c), (d), (e)
    and the GCN path on the card against the CPU's float32 step, the masks
    replayed (`_hold_step_against_cpu`), and the planted faults against
    the bf16 check.  (d) holds the PNA layers' dropout on the kernel path:
    its masks fall between the edge combine (row 6) and the BatchNorm
    affine the statistics kernel folds (row 2), and rows 8 and 5 run on the
    masked cotangent; (c) runs the same kernels without dropout."""
    for kind in ("b", "c", "d", "e", "gcn"):
        g, _ = _s16_batch(kind, "cpu", SLICE16_CHECK)
        masks = _s16_masks(kind, g)
        print(f"[slice16] ({kind}) {SLICE16_NAMES[kind]}: the step on "
              f"{SLICE16_CHECK} graphs, card against CPU, {len(masks)} "
              f"dropout masks replayed")
        _hold_step_against_cpu(
            lambda bf16, dev: _s16_one_step(kind, g, masks, bf16, dev),
            ("model",), SLICE16_FAULTS[kind], f"slice16 ({kind})",
            SLICE16_ZERO[kind])


def _s16_kernels(ga, gc) -> dict:
    """Item 1: rows 7 and 4 bit for bit at (a)'s batch (D = 300), rows 6,
    2, 8, 5 and 1 at (c)'s (D = 200)."""
    gen = torch.Generator(device="cuda").manual_seed(230)
    Ea, Ec = ga.senders.shape[0], gc.senders.shape[0]
    errs = {"csr_sum": _max_err(_hold_csr_sum("slice16 (a)", gen, ga,
                                              (GIN_WIDTH,)))}
    errs["edge_combine"] = _max_err(_hold_edge_combine("slice16 (c)", gen,
                                                       gc, (WIDTH,)))
    cases = [("(c)'s batch", gc.csr_row_ptr, gc.max_deg, Ec, WIDTH)]
    errs["pna_stats"] = _max_err(_hold_pna_stats("slice16", gen, cases))
    errs["pna_stats_bwd"] = _max_err(_hold_pna_stats_bwd("slice16", gen,
                                                         cases))
    errs["pair_segment_sum"] = _max_err(_hold_pair_segment_sum(
        "slice16 (c)", gen, gc, (WIDTH,)))
    _merge_errs(errs, _hold_walks(
        "slice16", gen, [("(c)'s batch", gc.csr_row_ptr, gc.max_deg, Ec,
                          (WIDTH,))],
        [("(a)'s batch", ga.csc_row_ptr, ga.csc_perm, Ea, (GIN_WIDTH,))]))
    return errs


def _s16_timed(smi: str):
    """Items 4 and 6: each configuration's bf16 step at its batch: the
    launches per step (exact), ms per step (CUDA events over warm steps),
    graphs/s, peak memory, kernels per step and the idle share of a
    profiled step."""
    from torch.profiler import ProfilerActivity, profile
    for kind in ("a", "b", "gcn", "c", "d", "e", "f"):
        args = _s16_args(kind, True)
        step = build_supervised_step(args, torch.device("cuda"))
        g, sizes = _s16_batch(kind, "cuda")
        gp = step.prepare(g)
        gen = torch.Generator(device="cuda").manual_seed(231)

        def one():
            return step.step(gp, noise=masks_source(gen))
        _reset_counts()
        loss = float(one())
        per, want = _counts(), _s16_launches(kind, True)
        _check(per == want and np.isfinite(loss),
               f"({kind}) launches per step {per} != {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(one, iters=SLICE16_TIMED, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        by_name = _profile_kernels(prof)
        kernels = sum(c for _, c in by_name.values())
        busy = sum(us for us, _ in by_name.values()) / 1e3
        print(f"[slice16] ({kind}) {SLICE16_NAMES[kind]}, bf16, batch "
              f"{args['batch_size']}: {ms:.3f} ms per step (CUDA events "
              f"over {SLICE16_TIMED} warm steps), "
              f"{args['batch_size'] / ms * 1e3:.1f} graphs/s, peak "
              f"max_memory_allocated {peak:.3f} GiB, {kernels} kernels per "
              f"step, device busy {busy:.3f} ms of the profiled step (idle "
              f"share {max(1 - busy / ms, 0.0):.3f}); launches per step "
              f"(exact) { {n: c for n, c in per.items() if c} }; batch "
              f"{sizes}; {smi}")
        del step, gp


def _s16_row_times(ga, smi: str):
    """Item 6: rows 7 and 4 at (a)'s shape (32 molecules, D = 300) in
    float32 and bf16, cold-L2 and warm, beside their byte bounds."""
    N, E, D = ga.num_nodes, ga.senders.shape[0], GIN_WIDTH
    e_real = int(ga.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(232)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        esz = 2 if dt == torch.bfloat16 else 4
        x = torch.randn(E, D, generator=gen, device="cuda").to(dt)
        calls = {"csr_sum (row 7)": (
            lambda: csr_sum(x, ga.csr_row_ptr), (N + 1) * 4 + N * D * 4),
            "snd_segment_sum (row 4)": (
                lambda: snd_segment_sum(x, ga.csc_row_ptr, ga.csc_perm),
                (N + 1) * 4 + e_real * 4 + N * D * esz)}
        for name, (fn, other_bytes) in calls.items():
            nbytes = e_real * D * esz + other_bytes
            bound_ms, by = _bound(nbytes, float(e_real * D))
            cold = device_ms(fn, iters=20, flush=flush)
            warm = device_ms(fn, iters=100, warmup=10)
            print(f"[slice16] {name} at (a)'s shape (N={N}, real E={e_real},"
                  f" D={D}, {dt}): {cold:.5f} ms cold-L2 median, {warm:.5f} "
                  f"ms warm; bound {bound_ms:.5f} ms by {by} "
                  f"({nbytes / 1e6:.3f} MB), {bound_ms / cold:.1%} of it "
                  f"cold; {smi}")


# the CLI runs: synthetic caches of each config's dataset (binary labels
# for the OGB sets, 19 QM9 targets), 1 epoch at the configs' batches
SLICE16_CACHES = {
    "ogbg_moltox21": dict(num=400, num_targets=12, seed=1, n_min=4,
                          n_max=48, split="scaffold"),
    "ogbg_molbace": dict(num=400, num_targets=1, seed=2, n_min=4, n_max=48,
                         split="scaffold"),
    "ogbg_molhiv": dict(num=400, num_targets=1, seed=3, n_min=4, n_max=48,
                        split="scaffold"),
    "QM9": dict(num=600, num_targets=19, seed=4, n_min=4, n_max=26)}
SLICE16_CLI = {"num_epochs": 1, "multithreaded_seeds": [],
               "log_iterations": 1, "use_tensorboard": False,
               "dataset_params": {}}
SLICE16_QM9_TRAIN = 256


def _write_slice16_caches(root: Path) -> Path:
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    for name, kw in SLICE16_CACHES.items():
        path = root / name / "processed.npz"
        write_synthetic_cache(str(path), **kw)
        if name.startswith("ogbg"):
            z = dict(np.load(path))
            z["targets"] = (z["targets"] > 0).astype(np.float32)
            np.savez(path, **z)
    return root


def _s16_cli_expected(kind: str, run: dict, steps: int) -> dict:
    from infomax3d_tpu_torch.cli.train import build_dataset, make_splits
    args = run["args"]
    _, val, test = make_splits(args, build_dataset(args))
    bs = args["batch_size"]
    evals = (args["num_epochs"] + 1) * -(-len(val) // bs) + \
        (-(-len(test) // bs) if args["eval_on_test"] and len(test) else 0)
    step, fwd = _s16_launches(kind, True), _s16_launches(kind, False)
    return {n: step[n] * steps + fwd[n] * evals for n in NONE}


def _s16_cli(out_dir: Path, caches: Path) -> dict:
    """Item 5: (a) to (f) through `cli.train.train` (1 epoch at the
    config's batch, bf16 as "auto" resolves on the card): finite losses, a
    validation loss, a checkpoint, the launches exact; (b)'s noise columns
    zero and its masks drawn; `pnatransformersimple_ogbg.yml` refused.
    Returns the launches (the main path)."""
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import build_models
    from infomax3d_tpu_torch.models import random_variants
    seen = {"zero": [], "masks": 0}
    real_cols, real_bern = random_variants.noise_columns, \
        GeneratorNoise.bernoulli

    def cols(*a):
        out = real_cols(*a)
        seen["zero"].append(not bool(out.any()))
        return out

    def bern(self, p, shape):
        seen["masks"] += 1
        return real_bern(self, p, shape)
    random_variants.noise_columns, GeneratorNoise.bernoulli = cols, bern
    _reset_counts()
    try:
        with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
            for kind, config in SLICE16.items():
                seen["zero"].clear()
                seen["masks"] = 0
                extra = {"num_train": SLICE16_QM9_TRAIN} \
                    if kind in ("c", "e") else {}
                run = _data_run(config, dict(SLICE16_CLI, **extra),
                                out_dir / f"slice16_{kind}", TRAINER_DEVICE)
                _check((run["dir"] / "best_checkpoint.pt").exists(),
                       f"({kind}) no checkpoint")
                loss = run["args"]["loss_func"]
                recs = [json.loads(x) for x in open(run["dir"] /
                                                     "metrics.jsonl")]
                train = [r[loss] for r in recs if r["split"] == "train"]
                val = [r[loss] for r in recs if r["split"] == "val"]
                _check(len(train) > 0 and len(val) == 1 and
                       all(np.isfinite(train + val)),
                       f"({kind}) CLI losses {train}, validation {val}")
                want = _s16_cli_expected(kind, run, len(train))
                _check(run["launches"] == want,
                       f"({kind}) CLI launches {run['launches']} != {want}")
                timing = json.load(open(run["dir"] / "timing.json"))
                note = ""
                if kind == "b":
                    _check(seen["zero"] and all(seen["zero"]) and
                           seen["masks"] > 0,
                           f"(b) noise columns zero {seen['zero'][:4]}, "
                           f"masks {seen['masks']}")
                    note = (f"; noise columns zero in all {len(seen['zero'])}"
                            f" draws, {seen['masks']} dropout masks drawn "
                            f"on the card")
                print(f"[slice16] ({kind}) CLI {config} ({run['args']['dataset']}"
                      f" cache, 1 epoch of {len(train)} steps at batch "
                      f"{run['args']['batch_size']}): {run['wall_s']:.1f} s, "
                      f"train losses {[round(x, 4) for x in train]}, "
                      f"validation {[round(x, 4) for x in val]}, step ms "
                      f"{[round(x, 2) for x in timing['step_ms']]}; launches "
                      f"{ {n: c for n, c in run['launches'].items() if c} }"
                      f"{note}")
    finally:
        random_variants.noise_columns, GeneratorNoise.bernoulli = \
            real_cols, real_bern
    launches = _counts()
    args = load_config(SLICE16_SIMPLE, {})
    try:
        build_models(args)
    except ValueError as e:
        print(f"[slice16] {SLICE16_SIMPLE}: refused, as the JAX package "
              f"fails on it: {e}")
    else:
        raise AssertionError(f"{SLICE16_SIMPLE} built a model")
    print(f"[slice16] main-path launches (the CLI runs): {launches}")
    return launches


def phase_slice16(smi: str, out_dir: Path) -> dict:
    """Phase 23: the GIN's options and the transformers through the
    supervised trainer.  Returns the main path's launches (the CLI runs)
    and the kernel checks' errors."""
    t = [time.perf_counter()]
    ga, _ = _s16_batch("a", "cuda")
    gc, _ = _s16_batch("c", "cuda")
    errs = _s16_kernels(ga, gc)
    t.append(time.perf_counter())
    _s16_checks()
    t.append(time.perf_counter())
    _s16_timed(smi)
    _s16_row_times(ga, smi)
    t.append(time.perf_counter())
    caches = _write_slice16_caches(out_dir / "slice16_caches")
    launches = _s16_cli(out_dir, caches)
    t.append(time.perf_counter())
    print("[slice16] seconds: " + ", ".join(
        f"{k} {b - a:.1f}" for k, a, b in zip(
            ("kernel checks", "step checks", "timings", "CLI runs"),
            t, t[1:])))
    return {"launches": launches, "errs": errs}


# ------------- phase 24: PNAOriginal and SMP through the trainers

SLICE17 = {"a": "configs/pna_original.yml",
           "b": "configs/pna_original_molhiv.yml",
           "c": "configs/pna_original_simple.yml",
           "d": "configs/contrastive_training_pna_original.yml",
           "e": "configs/SMP_geomol_conformers.yml"}
# the other configs of the slice: (c)'s and (e)'s architectures on other
# datasets, resolved and built through the CLI
SLICE17_ALSO = {"configs/pna_original_simple_molhiv.yml": "PNAOriginalSimple",
                "configs/SMP_rdkit_conformers.yml": "SMP",
                "configs/sphere_net.yml": "SMP"}
SLICE17_NAMES = {"a": "PNAOriginal 90x4, 5 towers, graph norm",
                 "b": "PNAOriginal 70x4, 5 towers, graph norm, molhiv",
                 "c": "PNAOriginalSimple 70x4, dropout 0.3, residual",
                 "d": "PNAOriginal 70x4 + flat Net3D, NT-Xent",
                 "e": "SMP 128x4, cutoff 5"}
# the batches: QM9-size molecules for (a), (c) and (e), molhiv-size for
# (b), drug-size for (d) (the config's GEOM-Drugs), each at its config's
# batch (128, 128, 128, 500, 32)
SLICE17_DATA = {"a": _QM9, "b": _MOLHIV, "c": _QM9, "d": CONF_DATA,
                "e": _QM9}
# the card-against-CPU checks: 31 graphs (an odd count, as phase 23's)
SLICE17_CHECK = 31
SLICE17_TIMED = 10


def _s17_args(kind: str, bf16: bool) -> dict:
    """The config's step as `build_supervised_step` / `build_step` take it
    (Adam at the config's lr)."""
    from infomax3d_tpu_torch.cli.config import load_config
    a = load_config(SLICE17[kind], {})
    out = {"model_type": a["model_type"],
           "model_parameters": dict(a["model_parameters"]),
           "loss_func": a["loss_func"],
           "optimizer_params": {"lr": a["optimizer_params"]["lr"]},
           "batch_size": a["batch_size"], "bf16_compute": bf16, "seed": 0,
           "collate_function": a["collate_function"]}
    if kind == "d":
        out.update(model3d_type="Net3D",
                   model3d_parameters=dict(a["model3d_parameters"]),
                   loss_params=dict(a["loss_params"]), num_conformers=1,
                   dataset_params=SLICE17_DATA["d"])
    return out


def _s17_launches(kind: str, step: bool) -> dict:
    """Launches per bf16 training step (`step`) or eval forward of `kind`.
    PNAOriginal: each tower's pretrans runs the edge combine (row 6, its
    backward row 5); the first layer's messages are bf16 and aggregate on
    the statistics kernel (row 2, backward row 8), the later layers' are
    float32 (the scaled aggregates promote, as in JAX) and aggregate on the
    multi-reduce (row 1, backward plain); (d) adds the flat Net3D's rows 6,
    7 and 5 per layer.  PNAOriginalSimple: each layer's sender gather
    (backward row 4), the first layer on row 2 / 8, the others on row 1.
    SMP: row 7 over the receivers in every node update and over the
    triplets in every edge update; the triplet gather's backward row 4 per
    edge update; `init_e`'s receiver and sender gathers, backward rows 3
    and 4."""
    mp = _s17_args(kind, True)["model_parameters"]
    L = mp.get("propagation_depth", 4)
    if kind == "e":
        return dict(NONE, csr_sum=1 + 2 * L,
                    **({"csr_segment_sum": 1, "snd_segment_sum": 1 + L}
                       if step else {}))
    if kind == "c":
        return dict(NONE, pna_stats=1, multi_reduce=L - 1,
                    **({"snd_segment_sum": L, "pna_stats_bwd": 1}
                       if step else {}))
    T = mp.get("towers", 1)
    out = dict(NONE, edge_combine=T * L, pna_stats=T, multi_reduce=T * (L - 1),
               **({"pair_segment_sum": T * L, "pna_stats_bwd": T}
                  if step else {}))
    if kind == "d":
        d3 = _s17_args("d", True)["model3d_parameters"]["propagation_depth"]
        net3d = {"edge_combine": d3, "csr_sum": d3,
                 **({"pair_segment_sum": d3} if step else {})}
        out = {n: c + net3d.get(n, 0) for n, c in out.items()}
    return out


def _s17_batch(kind: str, dev, batch_size: int = None):
    """(a) to (c), (e): `labelled_batch` at the config's batch (SMP's
    radius graphs and triplets at its cutoff); (d): `conformer_batches`
    with one conformer ((2D batch, 3D batch), sizes)."""
    a = _s17_args(kind, False)
    bs = batch_size or a["batch_size"]
    if kind == "d":
        g2, g3, sizes = conformer_batches(bs, 1, device=dev,
                                          **SLICE17_DATA["d"])
        return (g2, g3), sizes
    cutoff = a["model_parameters"].get("cutoff") if kind == "e" else None
    return labelled_batch(bs, a["model_parameters"].get("target_dim", 1),
                          device=dev, smp_cutoff=cutoff,
                          **SLICE17_DATA[kind])


def _s17_step(kind: str, bf16: bool, dev):
    args = _s17_args(kind, bf16)
    if kind == "d":
        return build_step(args, torch.device(dev))
    return build_supervised_step(args, torch.device(dev))


def _s17_masks(kind: str, g) -> list:
    """The dropout masks of one training forward of `kind` on `g`, drawn
    on the CPU (the step checks replay them on both sides)."""
    step = _s17_step(kind, False, "cpu")
    rec = GeneratorNoise(torch.Generator().manual_seed(97))
    with torch.no_grad():
        step.loss(step.prepare(g), noise=MasksOnly(rec))
    return rec.draws


def _s17_one_step(kind: str, g, masks: list, bf16: bool, dev: str):
    """`_measure_step` of one step of `kind` from the seeded weights (the
    masks replayed)."""
    step = _s17_step(kind, bf16, dev)
    if kind == "d":
        return _measure_step(step, {"model": step.model,
                                    "model3d": step.model3d},
                             step.prepare(*g))
    noise = MasksOnly(ReplayNoise([(k, t.to(dev)) for k, t in masks]))
    return _measure_step(step, {"model": step.model}, (step.prepare(g),),
                         noise=noise)


def _snorm_of_the_batch():
    """(a)'s and (d)'s planted fault: graph norm by 1 / sqrt of the batch's
    real nodes where it is each graph's."""
    from infomax3d_tpu_torch.models import pna_original as po
    real = po.PNATower.forward

    def forward(self, g, h, e, noise=None):
        n = g.node_mask.sum()
        snorm = (g.node_mask[:, None].float() / n.float().sqrt()).to(
            g.snorm.dtype)
        return real(self, dataclasses.replace(g, snorm=snorm), h, e, noise)
    po.PNATower.forward = forward
    return lambda: setattr(po.PNATower, "forward", real)


def _attenuation_as_amplification():
    """(b)'s planted fault: the attenuation scaler computed as the
    amplification (log(d + 1) / avg_d where it is avg_d / log(d + 1))."""
    from infomax3d_tpu_torch.models import pna_original as po
    real = po.pna_aggregate_parts_always_scaled

    def scaled(g, messages, aggregators, scalers, avg_d_log=1.0):
        return real(g, messages, aggregators,
                    [{"attenuation": "amplification"}.get(s, s)
                     for s in scalers], avg_d_log)
    return _patched(po.__name__, "pna_aggregate_parts_always_scaled", scaled)


def _s17_unscaled_dropout():
    """(c)'s planted fault: the dropout masks applied without the
    1 / keep_prob scale."""
    def unscaled(x, rate, source, training):
        if not training or rate == 0.0:
            return x
        keep = source.bernoulli(1.0 - rate, x.shape).to(x.device)
        return torch.where(keep, x, torch.zeros_like(x))
    return _patched("infomax3d_tpu_torch.models.pna_original", "drop",
                    unscaled)


def _kj_gathered_by_ji():
    """(e)'s planted fault: the edge updates gather each triplet's message
    at its edge j -> i (`idx_ji`) where they read the edge k -> j."""
    from infomax3d_tpu_torch.models import smp
    real = smp.SMPUpdateE.forward

    def forward(self, g, *a):
        return real(self, dataclasses.replace(g, idx_kj=g.idx_ji), *a)
    smp.SMPUpdateE.forward = forward
    return lambda: setattr(smp.SMPUpdateE, "forward", real)


def _kj_backward_unordered():
    """(e)'s other planted fault: the triplet gather's backward summing
    each edge's range of the triplets in their stored order (idx_ji's),
    the CSC permutation dropped."""
    from infomax3d_tpu_torch.models import smp
    real = smp.take_rows
    return _patched(smp.__name__, "take_rows",
                    lambda x, idx, ptr, perm: real(
                        x, idx, ptr, torch.arange(perm.shape[0],
                                                  dtype=perm.dtype,
                                                  device=perm.device)))


SLICE17_FAULTS = {
    "a": {"graph norm by the batch's node count": _snorm_of_the_batch},
    "b": {"the attenuation scaler computed as the amplification":
          _attenuation_as_amplification},
    "c": {"the dropout masks without their 1 / keep_prob scale":
          _s17_unscaled_dropout},
    "d": {"graph norm by the batch's node count": _snorm_of_the_batch},
    "e": {"the triplet message gathered at the edge j -> i":
          _kj_gathered_by_ji,
          "the triplet gather's backward without its CSC order":
          _kj_backward_unordered}}
# the zero-gradient leaves: the posttrans Linear's bias feeding its last
# BatchNorm (PNAOriginal's towers, PNAOriginalSimple's layers; (d) adds
# the Net3D's); SMP has no BatchNorm
SLICE17_ZERO = {"a": ZERO_GRADIENT, "b": ZERO_GRADIENT, "c": ZERO_GRADIENT,
                "d": ZERO_GRADIENT, "e": ()}


def _s17_checks():
    """One float32 and one bf16 step of each configuration on the card
    against the CPU's float32 step (`_hold_step_against_cpu`; (c)'s
    dropout masks replayed on both sides), and the planted faults against
    the bf16 check."""
    for kind in ("a", "b", "c", "d", "e"):
        g, sizes = _s17_batch(kind, "cpu", SLICE17_CHECK)
        masks = [] if kind == "d" else _s17_masks(kind, g)
        print(f"[slice17] ({kind}) {SLICE17_NAMES[kind]}: the step on "
              f"{SLICE17_CHECK} graphs ({sizes}), card against CPU, "
              f"{len(masks)} dropout masks replayed")
        _hold_step_against_cpu(
            lambda bf16, dev: _s17_one_step(kind, g, masks, bf16, dev),
            ("model", "model3d") if kind == "d" else ("model",),
            SLICE17_FAULTS[kind], f"slice17 ({kind})", SLICE17_ZERO[kind])


def _triplet_view(g):
    """The triplet sum's CSR as `_hold_csr_sum` reads a batch: the edges
    are its nodes, the triplets (sorted by `idx_ji`) its rows."""
    import types
    return types.SimpleNamespace(num_nodes=g.senders.shape[0],
                                 senders=g.idx_ji, csr_row_ptr=g.tri_ji_ptr)


def _s17_kernels(ga, gb, gc, ge) -> dict:
    """Every kernel of the slice's paths bit for bit at its new call sites:
    rows 6 and 5 at the towers' widths (90 and 18 at (a)'s batch, 70 and
    14 at (b)'s), rows 2 and 8 at the same shapes, row 1 there too (the
    float32 layers), row 4 at (c)'s batch (D = 70), and at (e)'s batch
    row 7 over the receivers (D = 128) and over the triplets (D = 64),
    row 4 keyed by `idx_kj` (D = 64) and by the senders (D = 128), row 3
    over the receivers (D = 128)."""
    gen = torch.Generator(device="cuda").manual_seed(240)
    wa = _s17_args("a", True)["model_parameters"]["hidden_dim"]
    wb = _s17_args("b", True)["model_parameters"]["hidden_dim"]
    towers = _s17_args("a", True)["model_parameters"]["towers"]
    me = _s17_args("e", True)["model_parameters"]
    he, ie = me["hidden_channels"], me["int_emb_size"]
    errs = {}
    pairs = {"edge_combine": [], "pair_segment_sum": []}
    for tag, g, widths in (("(a)", ga, (wa, wa // towers)),
                           ("(b)", gb, (wb, wb // towers))):
        pairs["edge_combine"] += _hold_edge_combine(f"slice17 {tag}", gen,
                                                    g, widths)
        pairs["pair_segment_sum"] += _hold_pair_segment_sum(
            f"slice17 {tag}", gen, g, widths)
    errs.update({n: _max_err(p) for n, p in pairs.items()})
    cases = [(f"{tag}'s batch", g.csr_row_ptr, g.max_deg,
              g.senders.shape[0], D)
             for tag, g, w in (("(a)", ga, wa), ("(b)", gb, wb))
             for D in (w, w // towers)]
    errs["pna_stats"] = _max_err(_hold_pna_stats("slice17", gen, cases))
    errs["pna_stats_bwd"] = _max_err(_hold_pna_stats_bwd("slice17", gen,
                                                         cases))
    Ee, T = ge.senders.shape[0], ge.idx_kj.shape[0]
    _merge_errs(errs, _hold_walks(
        "slice17",
        gen, [(f"{tag}'s batch", g.csr_row_ptr, g.max_deg, g.senders.shape[0],
               (w, w // towers))
              for tag, g, w in (("(a)", ga, wa), ("(b)", gb, wb))],
        [("(c)'s batch", gc.csc_row_ptr, gc.csc_perm, gc.senders.shape[0],
          (wb,)),
         ("(e)'s radius graph", ge.csc_row_ptr, ge.csc_perm, Ee, (he,)),
         ("(e)'s triplets by idx_kj", ge.tri_kj_ptr, ge.tri_kj_perm, T,
          (ie,))],
        [("(e)'s radius graph", ge.csr_row_ptr, Ee, (he,))]))
    errs["csr_sum"] = max(
        _max_err(_hold_csr_sum("slice17 (e) receivers", gen, ge, (he,))),
        _max_err(_hold_csr_sum("slice17 (e) triplets", gen,
                               _triplet_view(ge), (ie,))))
    return errs


def _ordered_kernel_us(prof, needles) -> list:
    """The device times (us) of the kernels whose names hold one of
    `needles`, in launch order."""
    from torch.profiler import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and any(n in e.name for n in needles)]
    return [e.time_range.elapsed_us()
            for e in sorted(evs, key=lambda e: e.time_range.start)]


def _s17_timed(smi: str) -> dict:
    """Each configuration's bf16 step at its batch: launches per step
    (exact), ms per step (CUDA events over warm steps), graphs/s, peak
    memory, kernels per step and the idle share of a profiled step; rows
    2 and 8 in (a)'s step (the first layer's towers) and row 7 over the
    triplets in (e)'s, each launch's mean device time beside its bound;
    the host ms of `smp_collate` per batch of (e).  Returns the in-step
    times."""
    from torch.profiler import ProfilerActivity, profile
    in_step = {}
    for kind in ("a", "b", "c", "d", "e"):
        step = _s17_step(kind, True, "cuda")
        g, sizes = _s17_batch(kind, "cuda")
        gp = step.prepare(*g) if kind == "d" else step.prepare(g)
        gen = torch.Generator(device="cuda").manual_seed(241)
        bs = _s17_args(kind, True)["batch_size"]

        def one():
            if kind == "d":
                return step.step(*gp)
            return step.step(gp, noise=masks_source(gen))
        _reset_counts()
        loss = float(one())
        per, want = _counts(), _s17_launches(kind, True)
        _check(per == want and np.isfinite(loss),
               f"({kind}) launches per step {per} != {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(one, iters=SLICE17_TIMED, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        by_name = _profile_kernels(prof)
        kernels = sum(c for _, c in by_name.values())
        busy = sum(us for us, _ in by_name.values()) / 1e3
        print(f"[slice17] ({kind}) {SLICE17_NAMES[kind]}, bf16, batch {bs}: "
              f"{ms:.3f} ms per step (CUDA events over {SLICE17_TIMED} warm "
              f"steps), {bs / ms * 1e3:.1f} graphs/s, peak "
              f"max_memory_allocated {peak:.3f} GiB, {kernels} kernels per "
              f"step, device busy {busy:.3f} ms of the profiled step (idle "
              f"share {max(1 - busy / ms, 0.0):.3f}); launches per step "
              f"(exact) { {n: c for n, c in per.items() if c} }; batch "
              f"{sizes}; {smi}")
        for kname, (us, c) in _port_kernels(by_name).items():
            print(f"[slice17] ({kind})   {kname}: {c} launches, "
                  f"{us / c:.2f} us each in the step")
        if kind == "a":
            _s17_tower_rows(gp, prof, in_step, smi)
        if kind == "e":
            _s17_triplet_rows(gp, prof, in_step, smi)
        del step, gp
    _s17_collate_ms(smi)
    return in_step


def _s17_tower_rows(g, prof, in_step: dict, smi: str):
    """Rows 2 and 8 in (a)'s step: the first layer's towers, D = 90, bf16,
    no affine, no sum section; beside the bytes each must move."""
    D = _s17_args("a", True)["model_parameters"]["hidden_dim"]
    N, E = g.num_nodes, g.senders.shape[0]
    e_real = int(g.csr_row_ptr[-1])
    bounds = {
        # the real message rows, row_ptr, 5 bf16 sections out; per message
        # element sum 1, sumsq 2, max / min 2, per output element ~8
        "pna_stats": (e_real * D * 2 + (N + 1) * 4 + 5 * N * D * 2,
                      5.0 * e_real * D + 8.0 * N * D),
        # the real x rows, the d_x rows (padding included), seven [N, D]
        # node arrays, row_ptr; ~18 flops per edge element (no affine)
        "pna_stats_bwd": (e_real * D * 2 + E * D * 2 + 7 * N * D * 2
                          + (N + 1) * 4, 18.0 * e_real * D)}
    for name, (nbytes, flops) in bounds.items():
        us = _ordered_kernel_us(prof, PROFILE_NAMES[name])
        bound_ms, by = _bound(nbytes, flops)
        mean = sum(us) / len(us) / 1e3
        in_step[f"{name} (a) towers"] = mean
        print(f"[slice17] {name} (row {2 if name == 'pna_stats' else 8}) in "
              f"(a)'s step at the tower shape (N={N}, real E={e_real}, "
              f"D={D}, bf16, no affine): {len(us)} launches, {mean:.5f} ms "
              f"each; bound {bound_ms:.5f} ms by {by} ({nbytes / 1e6:.3f} "
              f"MB), {bound_ms / mean:.1%} of it; {smi}")


def _s17_triplet_rows(g, prof, in_step: dict, smi: str):
    """Row 7 in (e)'s step: its launches alternate, in the forward, between
    the receivers' sums (the node updates, D = 128) and the triplets'
    (the edge updates, D = 64, float32); the triplets' beside their bytes,
    and the same call timed alone, cold-L2 and warm."""
    me = _s17_args("e", True)["model_parameters"]
    D, L = me["int_emb_size"], me["propagation_depth"]
    us = _ordered_kernel_us(prof, PROFILE_NAMES["csr_sum"])
    _check(len(us) == 1 + 2 * L, f"(e) csr_sum launches {len(us)}")
    tri = [us[2 * k + 1] for k in range(L)]
    E, T = g.senders.shape[0], g.idx_kj.shape[0]
    t_real = int(g.tri_ji_ptr[-1])
    nbytes = t_real * D * 4 + (E + 1) * 4 + E * D * 4
    bound_ms, by = _bound(nbytes, float(t_real * D))
    mean = sum(tri) / len(tri) / 1e3
    in_step["csr_sum (e) triplets"] = mean
    x = torch.randn(T, D, device="cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cold = device_ms(lambda: csr_sum(x, g.tri_ji_ptr), iters=20,
                     flush=flush)
    warm = device_ms(lambda: csr_sum(x, g.tri_ji_ptr), iters=100, warmup=10)
    print(f"[slice17] csr_sum (row 7) over (e)'s triplets (E={E} edges, "
          f"{t_real} real triplets of {T}, D={D}, float32, "
          f"{_sum_path(torch.float32, D, E, T)}): {mean:.5f} ms each in the "
          f"step ({len(tri)} launches), alone {cold:.5f} ms cold-L2, "
          f"{warm:.5f} ms warm; bound {bound_ms:.5f} ms by {by} "
          f"({nbytes / 1e6:.3f} MB), {bound_ms / mean:.1%} of it in the "
          f"step; {smi}")


def _s17_collate_ms(smi: str):
    """The host's `smp_collate` per batch of (e) (32 QM9-size molecules,
    cutoff 5): featurization, packing and sorting, as the loader's thread
    runs it."""
    from infomax3d_tpu_torch.data.loader import smp_collate
    a = _s17_args("e", True)
    ds = SyntheticMolecules(4 * a["batch_size"], **SLICE17_DATA["e"])
    cutoff = a["model_parameters"]["cutoff"]
    times = []
    for k in range(4):
        items = [{"graph2d": ds.graph2d(i), "targets": ds.targets[i]}
                 for i in range(k * a["batch_size"],
                                (k + 1) * a["batch_size"])]
        t0 = time.perf_counter()
        smp_collate(items, None, cutoff)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[slice17] (e) host smp_collate per batch of {a['batch_size']} "
          f"QM9-size molecules: {[round(t, 2) for t in times]} ms (4 "
          f"batches); {smi}")


# the CLI runs: synthetic caches of QM9 (19 targets, so `homo` and `r2`
# are there) for (a) and (e), 1 epoch each
SLICE17_CACHES = {"QM9": dict(num=600, num_targets=19, seed=5, n_min=4,
                              n_max=26)}
SLICE17_CLI = {"a": {"num_epochs": 1, "num_train": 256,
                     "log_iterations": 1, "use_tensorboard": False},
               "e": {"num_epochs": 1, "num_train": 64, "num_val": 32,
                     "log_iterations": 1, "use_tensorboard": False}}


def _s17_cli(out_dir: Path, caches: Path) -> dict:
    """(a) and (e) through `cli.train.train` (1 epoch at the config's
    batch, bf16 as "auto" resolves on the card): finite losses, a
    validation loss, a checkpoint, the launches exact; the slice's other
    configs resolved and built through the CLI.  Returns the launches
    (the main path)."""
    from infomax3d_tpu_torch.cli import train as cli
    from infomax3d_tpu_torch.cli.config import load_config
    _reset_counts()
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
        for kind in ("a", "e"):
            config = SLICE17[kind]
            run = _data_run(config, SLICE17_CLI[kind],
                            out_dir / f"slice17_{kind}", TRAINER_DEVICE)
            _check((run["dir"] / "best_checkpoint.pt").exists(),
                   f"({kind}) no checkpoint")
            loss = run["args"]["loss_func"]
            recs = [json.loads(x) for x in open(run["dir"] /
                                                 "metrics.jsonl")]
            train = [r[loss] for r in recs if r["split"] == "train"]
            val = [r[loss] for r in recs if r["split"] == "val"]
            _check(len(train) > 0 and len(val) == 1 and
                   all(np.isfinite(train + val)),
                   f"({kind}) CLI losses {train}, validation {val}")
            args = run["args"]
            _, v, t = cli.make_splits(args, cli.build_dataset(args))
            bs = args["batch_size"]
            evals = (args["num_epochs"] + 1) * -(-len(v) // bs) +                 (-(-len(t) // bs) if args["eval_on_test"] and len(t) else 0)
            want = _expect(_s17_launches(kind, True),
                           _s17_launches(kind, False), len(train), evals)
            _check(run["launches"] == want,
                   f"({kind}) CLI launches {run['launches']} != {want}")
            timing = json.load(open(run["dir"] / "timing.json"))
            print(f"[slice17] ({kind}) CLI {config} (QM9 cache, 1 epoch of "
                  f"{len(train)} steps at batch {bs}): {run['wall_s']:.1f} "
                  f"s, train losses {[round(x, 4) for x in train]}, "
                  f"validation {[round(x, 4) for x in val]}, step ms "
                  f"{[round(x, 2) for x in timing['step_ms']]}; launches "
                  f"{ {n: c for n, c in run['launches'].items() if c} }")
    launches = _counts()
    for config, model_type in list(SLICE17_ALSO.items()) + [
            (SLICE17["b"], "PNAOriginal"), (SLICE17["c"], "PNAOriginalSimple"),
            (SLICE17["d"], "PNAOriginal")]:
        args = load_config(config, {})
        cli.resolve_collate(args)
        cli.resolve_fast_paths(args)
        models = cli.build_models(args)
        _check(type(models["model"]).__name__ == model_type,
               f"{config}: built {type(models['model']).__name__}")
        print(f"[slice17] {config}: resolves and builds through the CLI "
              f"({model_type}, collate {args['collate_function']}, "
              f"{sum(p.numel() for p in models['model'].parameters())} "
              f"parameters)")
    print(f"[slice17] main-path launches (the CLI runs): {launches}")
    return launches


def _write_slice17_caches(root: Path) -> Path:
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    for name, kw in SLICE17_CACHES.items():
        write_synthetic_cache(str(root / name / "processed.npz"), **kw)
    return root


def phase_slice17(smi: str, out_dir: Path) -> dict:
    """Phase 24: PNAOriginal (with towers, graph norm and the simple
    variant) and SMP through the supervised and contrastive trainers.
    Returns the main path's launches (the CLI runs), the kernel checks'
    errors and the in-step times."""
    t = [time.perf_counter()]
    ga, _ = _s17_batch("a", "cuda")
    gb, _ = _s17_batch("b", "cuda")
    gc, _ = _s17_batch("c", "cuda")
    ge, _ = _s17_batch("e", "cuda")
    errs = _s17_kernels(ga, gb, gc, ge)
    t.append(time.perf_counter())
    _s17_checks()
    t.append(time.perf_counter())
    in_step = _s17_timed(smi)
    t.append(time.perf_counter())
    caches = _write_slice17_caches(out_dir / "slice17_caches")
    launches = _s17_cli(out_dir, caches)
    t.append(time.perf_counter())
    print("[slice17] seconds: " + ", ".join(
        f"{k} {b - a:.1f}" for k, a, b in zip(
            ("kernel checks", "step checks", "timings", "CLI runs"),
            t, t[1:])))
    return {"launches": launches, "errs": errs, "in_step": in_step}


# ------------- phase 25: BYOL, EGNN and SAN through the trainers

SLICE18 = {"a": "configs/byol.yml", "b": "configs/0.yml",
           "c": "configs/san.yml", "d": "configs/san_ogbg.yml"}
SLICE18_NAMES = {"a": "BYOL: PNA 90x6 + flat Net3D 20x1, predictors 256",
                 "b": "PNA 90x6 + EGNN 128x7, NT-Xent",
                 "c": "SAN 64x10, LPE 16x3, batch 4",
                 "d": "SAN 64x10, LPE 16x3, molhiv, batch 64",
                 "e": "EGNNTorch 128x4, egnn_dense's defaults"}
# (e): no config names the dense EGNN; `egnn_dense`'s defaults (4 layers,
# SiLU, residual, no attention, coords_weight 1) at (b)'s EGNN width on
# `egnn_padded_collate`'s batch, a QM9-size property (L1), batch 128
SLICE18_DENSE_EGNN = {
    "model_type": "EGNNTorch",
    "model_parameters": {"in_node_nf": 9, "hidden_dim": 128,
                         "target_dim": 1},
    "loss_func": "L1Loss", "optimizer_params": {"lr": 1.0e-4},
    "batch_size": 128, "collate_function": "egnn_padded_collate",
    "max_nodes": 40}
# QM9-size molecules for (a), (b), (c) and (e), molhiv-size for (d)
SLICE18_DATA = {"a": _QM9, "b": _QM9, "c": _QM9, "d": _MOLHIV, "e": _QM9}
# the card-against-CPU checks: 31 graphs (an odd count, as phases 23 and
# 24), the SAN ones 16 (the CPU's bf16 attention over the LPE's feed-forward
# of 2048 is slow)
SLICE18_CHECK = {"a": 31, "b": 31, "c": 16, "d": 16, "e": 31}
# the CPU's own bf16 distance from three readings (`_hold_step_against_cpu`
# `witnesses`): one reading is a single draw of the rounding noise, and the
# card's is another; at SAN (d)'s 16 graphs the CPU's loss read 6.2e-4
# and the card's 3.1e-3 (NVIDIA H100 80GB HBM3, 700 W)
SLICE18_WITNESSES = 3
SLICE18_TIMED = 10


def _s18_args(kind: str, bf16: bool) -> dict:
    """The configuration's step as `build_byol_step` (a), `build_step`
    (b) or `build_supervised_step` (c to e) take it (Adam at the config's
    lr); EGNN's input width is the complete graph's atom codes', as the
    CLI sets it from the data."""
    from infomax3d_tpu_torch.cli.config import load_config
    if kind == "e":
        return dict(SLICE18_DENSE_EGNN, bf16_compute=bf16, seed=0)
    a = load_config(SLICE18[kind], {})
    out = {"model_parameters": dict(a["model_parameters"]),
           "loss_func": a["loss_func"],
           "optimizer_params": {"lr": a["optimizer_params"]["lr"]},
           "batch_size": a["batch_size"], "bf16_compute": bf16, "seed": 0,
           "collate_function": a["collate_function"],
           "max_nodes": a["max_nodes"], "model_type": a["model_type"]}
    if kind in ("a", "b"):
        out.update(model3d_type=a["model3d_type"],
                   model3d_parameters=dict(a["model3d_parameters"]),
                   loss_params=dict(a.get("loss_params") or {}),
                   dataset_params=SLICE18_DATA[kind], num_conformers=1)
    if kind == "b":
        out["model3d_parameters"]["node_dim"] = 9
    return out


def _s18_step(kind: str, bf16: bool, dev):
    from infomax3d_tpu_torch.train.byol import build_byol_step
    args = _s18_args(kind, bf16)
    dev = torch.device(dev)
    if kind == "a":
        return build_byol_step(args, dev)
    if kind == "b":
        return build_step(args, dev)
    return build_supervised_step(args, dev)


def _s18_batch(kind: str, dev, batch_size: int = None):
    """(a), (b): `conformer_batches` with one conformer (the CSR complete
    graphs of `contrastive_collate`), ((2D batch, 3D batch), sizes); (c),
    (d): `labelled_batch`'s dense `san_collate` batch; (e) the
    `egnn_padded_collate` batch of labelled molecules."""
    from infomax3d_tpu_torch.data.loader import egnn_padded_collate
    from infomax3d_tpu_torch.graphs.dense import to_dense_batch
    a = _s18_args(kind, False)
    bs = batch_size or a["batch_size"]
    if kind in ("a", "b"):
        g2, g3, sizes = conformer_batches(bs, 1, device=dev,
                                          **SLICE18_DATA[kind])
        return (g2, g3), sizes
    if kind in ("c", "d"):
        return labelled_batch(bs, 1, device=dev, dense=True,
                              max_nodes=a["max_nodes"], **SLICE18_DATA[kind])
    ds = SyntheticMolecules(bs, num_targets=1, **SLICE18_DATA[kind])
    items = [{"graph2d": ds.graph2d(i), "targets": ds.targets[i]}
             for i in range(bs)]
    nmax = max(a["max_nodes"], max(it["graph2d"]["node_feat"].shape[0]
                                   for it in items))
    view = egnn_padded_collate(items, bucket_for(
        [it["graph2d"] for it in items], bs), nmax)["graph"]
    return to_dense_batch(view, dev), {
        "graphs": bs, "slots": nmax,
        "nodes": int(view["node_mask"].sum())}


def _s18_masks(kind: str, g) -> list:
    """SAN's dropout masks of one training forward on `g`, drawn on the
    CPU (the step checks replay them on both sides); none elsewhere."""
    if kind not in ("c", "d"):
        return []
    step = _s18_step(kind, False, "cpu")
    rec = GeneratorNoise(torch.Generator().manual_seed(97))
    with torch.no_grad():
        step.loss(step.prepare(g), noise=MasksOnly(rec))
    return rec.draws


def _s18_one_step(kind: str, g, masks: list, bf16: bool, dev: str,
                  perturb: float = 0.0):
    """`_measure_step` of one step of `kind` from the seeded weights (the
    masks replayed; the weights perturbed by `perturb`)."""
    step = _s18_step(kind, bf16, dev)
    if kind in ("a", "b"):
        return _measure_step(step, {"model": step.model,
                                    "model3d": step.model3d},
                             step.prepare(*g), perturb=perturb)
    noise = MasksOnly(ReplayNoise([(k, t.to(dev)) for k, t in masks]))
    return _measure_step(step, {"model": step.model}, (step.prepare(g),),
                         perturb=perturb, noise=noise)


def _s18_launches(kind: str, step: bool) -> dict:
    """Launches per bf16 training step (`step`) or eval forward of `kind`.
    PNA: per layer the edge combine (row 6) and the statistics (row 2),
    their backwards rows 5 and 8.  BYOL adds each teacher's forward (no
    backward): the 2D teacher's rows 6 and 2 per layer, the 3D teacher's
    rows 6 and 7; the flat Net3D runs rows 6, 7 and 5 per layer.  EGNN
    (float32 under the recipe, as in JAX) runs rows 6, 7 and 5 per layer.
    SAN and the dense EGNN run no kernel of the port."""
    if kind in ("c", "d", "e"):
        return dict(NONE)
    a = _s18_args(kind, True)
    if kind == "a":
        inner = a["model_parameters"]["model_parameters"]
        d3 = a["model3d_parameters"]["model_parameters"]["propagation_depth"]
        copies = 2             # student and teacher
    else:
        inner, copies = a["model_parameters"], 1
        d3 = a["model3d_parameters"]["propagation_depth"]
    L = inner["propagation_depth"]
    out = dict(NONE, edge_combine=copies * (L + d3), pna_stats=copies * L,
               csr_sum=copies * d3)
    if step:
        out.update(pair_segment_sum=L + d3, pna_stats_bwd=L)
    return out


def _byol_teacher_in_eval():
    """(a)'s planted fault: the teachers run in eval mode (their running
    statistics) in training."""
    from infomax3d_tpu_torch.train import byol
    from infomax3d_tpu_torch.train.precision import forward_in
    real = byol.BYOLStep.teacher_projections

    def projections(self, g2, g3):
        with torch.no_grad():
            return [forward_in(self.teachers[k].eval(), self.compute_dtype,
                               g).float()
                    for k, g in (("model", g2), ("model3d", g3))]
    byol.BYOLStep.teacher_projections = projections
    return lambda: setattr(byol.BYOLStep, "teacher_projections", real)


def _byol_own_side():
    """(a)'s planted fault: each prediction paired with its own side's
    teacher projection."""
    from infomax3d_tpu_torch.train import byol
    from infomax3d_tpu_torch.train.precision import forward_in
    real = byol.BYOLStep.loss

    def loss(self, g2, g3):
        pred2, _ = forward_in(self.model, self.compute_dtype, g2)
        pred3, _ = forward_in(self.model3d, self.compute_dtype, g3)
        proj2_t, proj3_t = self.teacher_projections(g2, g3)
        return (self.loss_fn(pred2, proj2_t) + self.loss_fn(proj3_t, pred3),
                (pred2, pred3))
    byol.BYOLStep.loss = loss
    return lambda: setattr(byol.BYOLStep, "loss", real)


def _receiver_only_distance():
    """(b)'s planted fault: each edge's squared distance from the
    receiver's coordinates alone."""
    def sq(g):
        N = g.coords.shape[0]
        xd = g.coords[g.receivers.long().clamp(0, N - 1)]
        return (xd ** 2).sum(dim=-1, keepdim=True)
    return _patched("infomax3d_tpu_torch.models.egnn", "squared_distances",
                    sq)


def _gate_dropped():
    """(b)'s planted fault: the messages aggregated without the sigmoid
    gate of `soft_edge_network`."""
    from infomax3d_tpu_torch.models import egnn
    real = egnn.EGCLayer.forward

    def forward(self, g, h, noise=None):
        msg = self.message_network(
            egnn.EdgeInput(h, g.senders, g.receivers,
                           egnn.squared_distances(g), g.csr_row_ptr,
                           g.csc_row_ptr, g.csc_perm), g.edge_mask,
            noise=noise)
        agg = egnn.edge_aggregate(g, msg, self.reduce_func)
        return self.update_network(agg + h, g.node_mask, noise=noise) + h
    egnn.EGCLayer.forward = forward
    return lambda: setattr(egnn.EGCLayer, "forward", real)


def _fake_on_real_mask():
    """(c)'s planted fault: the channels' masks swapped, so the fake
    channel scores the real bonds and the real channel the other pairs."""
    from infomax3d_tpu_torch.models import san
    real = san.SANAttention.forward

    def forward(self, g, h, e_real, e_fake):
        pair = g.node_mask[:, :, None] & g.node_mask[:, None, :]
        return real(self, dataclasses.replace(
            g, real_edge_mask=pair & ~g.real_edge_mask), h, e_real, e_fake)
    san.SANAttention.forward = forward
    return lambda: setattr(san.SANAttention, "forward", real)


def _score_clamp_dropped():
    """(c)'s planted fault: the attention scores' clamp at +-5 dropped."""
    return _patched("infomax3d_tpu_torch.models.san", "SCORE_CLAMP",
                    float("inf"))


SLICE18_FAULTS = {
    "a": {"the teachers in eval mode": _byol_teacher_in_eval,
          "each prediction against its own side's projection":
          _byol_own_side},
    "b": {"the squared distance from the receiver alone":
          _receiver_only_distance,
          "the soft edge gate dropped": _gate_dropped},
    "c": {"the fake channel on the real bonds' mask": _fake_on_real_mask,
          "the score clamp dropped": _score_clamp_dropped},
    "d": {}, "e": {}}
# the zero-gradient leaves: a bias (or a mid BatchNorm's shift) feeding a
# BatchNorm with nothing nonlinear between (PNA's and the flat Net3D's;
# EGNN's single-layer input MLP and the last two layers of its update and
# node-wise MLPs; SAN's O_h and second FFN layer through their
# residuals); the dense EGNN's last coordinate head, whose coordinates
# nothing reads
EGNN_ZERO = ZERO_GRADIENT[:3] + tuple(
    f"{net}.fully_connected.{leaf}" for net in ("update_network",
                                                 "node_wise_output_network")
    for leaf in ("0.batch_norm.bias", "1.linear.bias")) + (
    "input.fully_connected.0.linear.bias",)
SAN_ZERO = ("O_h.bias", "FFN_h_layer2.bias")
_DENSE_LAST = SLICE18_DENSE_EGNN["model_parameters"].get("n_layers", 4) - 1
DENSE_EGNN_ZERO = tuple(f"gcl_{_DENSE_LAST}.{leaf}" for leaf in (
    "coord_mlp_1.weight", "coord_mlp_1.bias", "coord_mlp_out.weight"))
SLICE18_ZERO = {"a": ZERO_GRADIENT, "b": EGNN_ZERO, "c": SAN_ZERO,
                "d": SAN_ZERO, "e": DENSE_EGNN_ZERO}


def _s18_checks(kinds: tuple = ("a", "b", "c", "d", "e")):
    """One float32 and one bf16 step of each configuration on the card
    against the CPU's float32 step (`_hold_step_against_cpu`; SAN's
    dropout masks replayed on both sides), and the planted faults against
    the bf16 check (the CPU's own bf16 distance the largest of
    SLICE18_WITNESSES readings); (b)'s against the float32 one: EGNN
    computes in float32 under the recipe, and its faults move the bf16
    step about as far as the PNA side's bf16 rounding does (a CPU run:
    the receiver-only distance read 1.59 on a leaf limited at 1.22)."""
    for kind in kinds:
        g, sizes = _s18_batch(kind, "cpu", SLICE18_CHECK[kind])
        masks = _s18_masks(kind, g)
        print(f"[slice18] ({kind}) {SLICE18_NAMES[kind]}: the step on "
              f"{SLICE18_CHECK[kind]} graphs ({sizes}), card against CPU, "
              f"{len(masks)} dropout masks replayed")
        _hold_step_against_cpu(
            lambda bf16, dev, perturb=0.0: _s18_one_step(
                kind, g, masks, bf16, dev, perturb),
            ("model", "model3d") if kind in ("a", "b") else ("model",),
            SLICE18_FAULTS[kind], f"slice18 ({kind})", SLICE18_ZERO[kind],
            fault_bf16=kind != "b", witnesses=SLICE18_WITNESSES)


def _teacher_state(step) -> dict:
    """Every teacher tensor of a `BYOLStep` (parameters and running
    statistics), cloned, named ``<model>.<name>``."""
    return {f"{k}.{n}": v.detach().clone()
            for k, t in step.teachers.items()
            for n, v in t.state_dict().items()}


def _byol_state_violations(step, before: dict) -> list:
    """What the BYOL state after one step breaks: the 2D teacher moved by
    exactly the EMA toward its updated student (``t * d + s * (1 - d)``,
    the same float32 operations), the 3D teacher's parameters unchanged
    (the default: only the 2D teacher moves), both teachers' running
    statistics moved (train-mode teachers)."""
    bad = []
    d = step.ma_decay
    for key in ("model", "model3d"):
        student = dict(getattr(step, key).student.named_parameters())
        for n, t in step.teachers[key].named_parameters():
            t0 = before[f"{key}.{n}"]
            want = t0 * d + student[n].detach() * (1.0 - d) \
                if key == "model" else t0
            if not torch.equal(t, want):
                bad.append(f"{key} teacher {n}: max |t - want| "
                           f"{float((t - want).abs().max()):.3g}")
        for n, b in step.teachers[key].named_buffers():
            if "running" in n and torch.equal(b, before[f"{key}.{n}"]):
                bad.append(f"{key} teacher {n}: did not move")
    return bad


def _s18_byol_state(smi: str):
    """(a)'s state after one full bf16 step at its batch: the teachers as
    `_byol_state_violations` holds them, and the planted fault (the EMA on
    both teachers, not only the 2D one) that must break it; and the
    teachers' no-grad train-mode forwards through rows 6, 2 and 7 against
    the same forwards through the plain versions on the card, bit for bit
    (projections and running statistics)."""
    from infomax3d_tpu_torch.ops.kernels import _build
    g, sizes = _s18_batch("a", "cuda")
    for fault in (None, "the EMA on both teachers"):
        step = _s18_step("a", True, "cuda")
        gp = step.prepare(*g)
        if fault:
            step.ema_keys = ("model", "model3d")
        before = _teacher_state(step)
        step.step(*gp)
        torch.cuda.synchronize()
        bad = _byol_state_violations(step, before)
        if fault is None:
            _check(not bad, f"(a) BYOL state after a step: {bad[:4]}")
            print(f"[slice18] (a) after one bf16 step at batch "
                  f"{sizes['graphs']}: the 2D teacher moved by exactly the "
                  f"EMA (decay {step.ma_decay}) toward its student, the 3D "
                  f"teacher's parameters unchanged, both teachers' running "
                  f"statistics moved")
        else:
            _check(bool(bad), f"the BYOL state check passed a planted fault "
                              f"({fault})")
            print(f"[slice18] (a) planted fault ({fault}): "
                  f"{len(bad)} violations, e.g. {bad[:2]}")
    state = _teacher_state(step)

    def restore():
        for key, t in step.teachers.items():
            t.load_state_dict({n[len(key) + 1:]: v for n, v in state.items()
                               if n.startswith(key + ".")})
    runs = {}
    real = _build.on_card
    for how in ("kernels", "plain versions"):
        restore()
        _reset_counts()
        if how == "plain versions":
            _build.on_card = lambda t, name: False
        try:
            proj = step.teacher_projections(*gp)
        finally:
            _build.on_card = real
        torch.cuda.synchronize()
        runs[how] = (proj, _teacher_state(step), _counts())
    a = _s18_args("a", True)
    L = a["model_parameters"]["model_parameters"]["propagation_depth"]
    d3 = a["model3d_parameters"]["model_parameters"]["propagation_depth"]
    want = dict(NONE, edge_combine=L + d3, pna_stats=L, csr_sum=d3)
    (pk, sk, ck), (pp, sp, cp) = runs["kernels"], runs["plain versions"]
    _check(ck == want and cp == dict(NONE),
           f"(a) teacher forwards launched {ck} / {cp}")
    same = all(torch.equal(a, b) for a, b in zip(pk, pp)) and all(
        torch.equal(sk[n], sp[n]) for n in sk)
    _check(same, "(a) the teachers' forwards through the kernels differ "
                 "from the plain versions")
    print(f"[slice18] (a) the teachers' no-grad train-mode forwards: "
          f"projections and running statistics bit-exact between the "
          f"kernels ({ {n: c for n, c in ck.items() if c} }) and the plain "
          f"versions on the card")
    restore()


def _s18_kernels(ga, gb) -> dict:
    """Every kernel of the slice's paths bit for bit at its new call
    sites: at (a)'s batch (250 molecules) rows 6, 5, 2, 8 and 1 on the
    2D bond graphs at the PNA width (90) and rows 6, 5 and 7 on the
    complete graphs at the flat Net3D's (20); at (b)'s (500) rows 2 and 8
    on the bond graphs at 90 and rows 6, 5 and 7 on the complete graphs
    at EGNN's width (128)."""
    gen = torch.Generator(device="cuda").manual_seed(250)
    (a2, a3), (b2, b3) = ga, gb
    w = _s18_args("a", True)["model_parameters"]["model_parameters"][
        "hidden_dim"]
    w3a = _s18_args("a", True)["model3d_parameters"]["model_parameters"][
        "hidden_dim"]
    w3b = _s18_args("b", True)["model3d_parameters"]["hidden_dim"]
    errs = {}
    pairs = {"edge_combine": [], "pair_segment_sum": [], "csr_sum": []}
    for tag, g, width in (("(a) bonds", a2, w), ("(a) complete graphs", a3,
                                                  w3a),
                          ("(b) complete graphs", b3, w3b)):
        pairs["edge_combine"] += _hold_edge_combine(f"slice18 {tag}", gen,
                                                    g, (width,))
        pairs["pair_segment_sum"] += _hold_pair_segment_sum(
            f"slice18 {tag}", gen, g, (width,))
        if "complete" in tag:
            pairs["csr_sum"] += _hold_csr_sum(f"slice18 {tag}", gen, g,
                                              (width,))
    errs.update({n: _max_err(p) for n, p in pairs.items()})
    cases = [(f"{tag}'s bonds", g.csr_row_ptr, g.max_deg, g.senders.shape[0],
              w) for tag, g in (("(a)", a2), ("(b)", b2))]
    errs["pna_stats"] = _max_err(_hold_pna_stats("slice18", gen, cases))
    errs["pna_stats_bwd"] = _max_err(_hold_pna_stats_bwd("slice18", gen,
                                                         cases))
    _merge_errs(errs, _hold_walks(
        "slice18", gen, [("(a)'s bonds", a2.csr_row_ptr, a2.max_deg,
                          a2.senders.shape[0], (w,))], []))
    return errs


def _s18_timed(smi: str):
    """Each configuration's bf16 step at its batch: launches per step
    (exact), ms per step (CUDA events over warm steps), graphs/s, peak
    memory, kernels per step and the idle share of a profiled step."""
    from torch.profiler import ProfilerActivity, profile
    for kind in ("a", "b", "c", "d", "e"):
        step = _s18_step(kind, True, "cuda")
        g, sizes = _s18_batch(kind, "cuda")
        gp = step.prepare(*g) if kind in ("a", "b") else step.prepare(g)
        gen = torch.Generator(device="cuda").manual_seed(251)
        bs = _s18_args(kind, True)["batch_size"]

        def one():
            if kind in ("a", "b"):
                return step.step(*gp)
            return step.step(gp, noise=masks_source(gen))
        _reset_counts()
        loss = float(one())
        per, want = _counts(), _s18_launches(kind, True)
        _check(per == want and np.isfinite(loss),
               f"({kind}) launches per step {per} != {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(one, iters=SLICE18_TIMED, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        by_name = _profile_kernels(prof)
        kernels = sum(c for _, c in by_name.values())
        busy = sum(us for us, _ in by_name.values()) / 1e3
        print(f"[slice18] ({kind}) {SLICE18_NAMES[kind]}, bf16, batch {bs}: "
              f"{ms:.3f} ms per step (CUDA events over {SLICE18_TIMED} warm "
              f"steps), {bs / ms * 1e3:.1f} graphs/s, peak "
              f"max_memory_allocated {peak:.3f} GiB, {kernels} kernels per "
              f"step, device busy {busy:.3f} ms of the profiled step (idle "
              f"share {max(1 - busy / ms, 0.0):.3f}); launches per step "
              f"(exact) { {n: c for n, c in per.items() if c} }; batch "
              f"{sizes}; {smi}")
        for kname, (us, c) in _port_kernels(by_name).items():
            print(f"[slice18] ({kind})   {kname}: {c} launches, "
                  f"{us / c:.2f} us each in the step")
        del step, gp


# the CLI runs: one synthetic QM9 cache (19 targets, so `homo` is there)
# with the contiguous split of `num_val`, 1 epoch each at the config's
# batch: (a) 2 steps of 250, (b) 1 of 500, (c) 16 of 4
SLICE18_CACHES = {"QM9": dict(num=1500, num_targets=19, seed=6, n_min=4,
                              n_max=26)}
_S18_CLI = {"num_epochs": 1, "log_iterations": 1, "use_tensorboard": False,
            "multithreaded_seeds": [], "dataset_params": {}}
SLICE18_CLI = {"a": dict(_S18_CLI, num_train=500, num_val=250),
               "b": dict(_S18_CLI, num_train=500, num_val=500),
               "c": dict(_S18_CLI, num_train=64, num_val=32)}


def _s18_cli(out_dir: Path, caches: Path) -> dict:
    """(a), (b) and (c) through `cli.train.train` (1 epoch at the config's
    batch, bf16 as "auto" resolves on the card): finite losses, a
    validation loss, a checkpoint (with the teachers for (a)), the
    launches exact; (d) resolved and built through the CLI.  Returns the
    launches (the main path)."""
    from infomax3d_tpu_torch.cli import train as cli
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.train import checkpoint
    _reset_counts()
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
        for kind in ("a", "b", "c"):
            config = SLICE18[kind]
            # the uniformity metric, log mean exp(-2 |x - y|^2) over the
            # predictions' pairs, is -inf where they all lie farther apart
            # than float32's exp reaches, as BYOL's untrained predictors
            # put them (in JAX as here)
            run = _data_run(config, SLICE18_CLI[kind],
                            out_dir / f"slice18_{kind}", TRAINER_DEVICE,
                            unbounded=("uniformity",))
            ckpt = run["dir"] / "best_checkpoint.pt"
            _check(ckpt.exists(), f"({kind}) no checkpoint")
            if kind == "a":
                sd = checkpoint.load_checkpoint(str(ckpt))["model_state_dict"]
                _check(any(n.startswith("teacher.") for n in sd),
                       "(a) the checkpoint holds no teacher")
            loss = run["args"]["loss_func"]
            recs = [json.loads(x) for x in open(run["dir"] /
                                                 "metrics.jsonl")]
            train = [r[loss] for r in recs if r["split"] == "train"]
            val = [r[loss] for r in recs if r["split"] == "val"]
            _check(len(train) > 0 and len(val) == 1 and
                   all(np.isfinite(train + val)),
                   f"({kind}) CLI losses {train}, validation {val}")
            args = run["args"]
            _, v, t = cli.make_splits(args, cli.build_dataset(args))
            bs = args["batch_size"]
            drop = kind in ("a", "b")       # the contrastive loaders
            n_batches = (lambda n: n // bs) if drop else \
                (lambda n: -(-n // bs))
            evals = (args["num_epochs"] + 1) * n_batches(len(v)) + (
                n_batches(len(t)) if args["eval_on_test"] and len(t) else 0)
            want = _expect(_s18_launches(kind, True),
                           _s18_launches(kind, False), len(train), evals)
            _check(run["launches"] == want,
                   f"({kind}) CLI launches {run['launches']} != {want}")
            timing = json.load(open(run["dir"] / "timing.json"))
            print(f"[slice18] ({kind}) CLI {config} (QM9 cache, 1 epoch of "
                  f"{len(train)} steps at batch {bs}): {run['wall_s']:.1f} "
                  f"s, train losses {[round(x, 4) for x in train]}, "
                  f"validation {[round(x, 4) for x in val]}, step ms "
                  f"{[round(x, 2) for x in timing['step_ms']]}; launches "
                  f"{ {n: c for n, c in run['launches'].items() if c} }")
    launches = _counts()
    args = load_config(SLICE18["d"], {})
    cli.resolve_collate(args)
    cli.resolve_fast_paths(args)
    models = cli.build_models(args)
    _check(type(models["model"]).__name__ == "SAN",
           f"{SLICE18['d']}: built {type(models['model']).__name__}")
    print(f"[slice18] {SLICE18['d']}: resolves and builds through the CLI "
          f"(SAN, collate {args['collate_function']}, "
          f"{sum(p.numel() for p in models['model'].parameters())} "
          f"parameters)")
    print(f"[slice18] main-path launches (the CLI runs): {launches}")
    return launches


def _write_slice18_caches(root: Path) -> Path:
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    for name, kw in SLICE18_CACHES.items():
        write_synthetic_cache(str(root / name / "processed.npz"), **kw)
    return root


def phase_slice18(smi: str, out_dir: Path) -> dict:
    """Phase 25: BYOL, EGNN (flat and dense) and SAN through the trainers.
    Returns the main path's launches (the CLI runs) and the kernel
    checks' errors."""
    t = [time.perf_counter()]
    ga, _ = _s18_batch("a", "cuda")
    gb, _ = _s18_batch("b", "cuda")
    errs = _s18_kernels(ga, gb)
    del ga, gb
    t.append(time.perf_counter())
    _s18_checks()
    _s18_byol_state(smi)
    t.append(time.perf_counter())
    _s18_timed(smi)
    t.append(time.perf_counter())
    caches = _write_slice18_caches(out_dir / "slice18_caches")
    launches = _s18_cli(out_dir, caches)
    t.append(time.perf_counter())
    print("[slice18] seconds: " + ", ".join(
        f"{k} {b - a:.1f}" for k, a, b in zip(
            ("kernel checks", "step checks", "timings", "CLI runs"),
            t, t[1:])))
    return {"launches": launches, "errs": errs}


# ------------- phase 26: the last trainers, losses and model names

# configs_clean/pre-train_QM9.yml's architecture (PNA 200x7, the flat Net3D
# 20x1 on the CSR complete graphs) under the three trainer flavours, and
# the model names at its PNA width as supervised L1 steps on labelled
# QM9-size molecules (one target)
SLICE19_CONFIG = "configs_clean/pre-train_QM9.yml"
SLICE19_NAMES = {
    "phil": "philosophy: PNA 200x7 + flat Net3D 20x1, Critic 256 x 2 "
            "layers x 4 repeats, CriticLoss",
    "alt_even": "alternating, an even step (the 2D side learns)",
    "alt_odd": "alternating, an odd step (the 3D side learns, the loss's "
               "arguments swapped)",
    "noisy": "noisy negatives: one noised 3D copy, NTXentExtraNegatives",
    "pnar": "PNARandom 200x7, 10 noise columns (zeros: masks only)",
    "pner": "PNARandomEdgeUpdate 200x7, 10 noise columns (zeros)",
    "pair": "PNA 200x7 with pairwise_distances",
}
SLICE19_KINDS = tuple(SLICE19_NAMES)
SLICE19_SUPERVISED = ("pnar", "pner", "pair")
SLICE19_CRITIC = {"metric_dim": 256, "hidden_dim": 256, "layers": 2,
                  "repeats": 4}
SLICE19_CHECK = 31
SLICE19_TIMED = 10
# the float32 steps that are ill-conditioned get float32 witnesses
# (`_hold_step_against_cpu`): on the CPU, weights scaled by 1 + 2^-20
# U(-1, 1) moved PNARandom's float32 loss by 2.0e-5 (STEP_TOL: 1e-5) and
# PNARandomEdgeUpdate's by 3.1e-5, a leaf of it by 1.6 and its L2 by
# 4.9e-3 (its max / min winners flip), the pairwise PNA's loss by 1.4e-6
SLICE19_F32_WITNESSES = {"pnar": 3, "pner": 3}
# the leaves whose exact gradient is 0 beyond ZERO_GRADIENT's: the edge
# update layers' message and node MLPs end in a Linear feeding a BatchNorm
SLICE19_ZERO = ZERO_GRADIENT + ("posttrans_1.fully_connected.0.linear.bias",
                                "posttrans_2.fully_connected.0.linear.bias")


def _s19_config() -> dict:
    from infomax3d_tpu_torch.cli.config import load_config
    return load_config(SLICE19_CONFIG, {})


def _s19_args(kind: str, bf16: bool) -> dict:
    """`build_step` (the flavours) or `build_supervised_step` (the model
    names) arguments of `kind`, at the config's widths and lr."""
    a = _s19_config()
    lr = {"lr": a["optimizer_params"]["lr"]}
    if kind not in SLICE19_SUPERVISED:
        loss = ("NTXentExtraNegatives", dict(a["loss_params"])) \
            if kind == "noisy" else (a["loss_func"], dict(a["loss_params"]))
        return {"model_parameters": dict(a["model_parameters"]),
                "model3d_type": "Net3D",
                "model3d_parameters": dict(a["model3d_parameters"]),
                "loss_func": loss[0], "loss_params": loss[1],
                "optimizer_params": lr, "bf16_compute": bf16, "seed": 0}
    mp = dict(a["model_parameters"], target_dim=1)
    name = {"pnar": "PNARandom", "pner": "PNARandomEdgeUpdate",
            "pair": "PNA"}[kind]
    if kind == "pair":
        mp["pairwise_distances"] = True
    else:
        mp.update(random_vec_dim=10, random_vec_std=1.0)
    return {"model_type": name, "model_parameters": mp,
            "loss_func": "L1Loss", "optimizer_params": lr,
            "bf16_compute": bf16, "seed": 0}


def _s19_step(kind: str, bf16: bool, dev):
    """The step of `kind` from the seeded weights: a `SupervisedStep`, or
    the flavour's step over `build_step`'s PNA and Net3D (the critic
    seeded too, each model its own Adam for philosophy)."""
    from infomax3d_tpu_torch.interop import flax_paths, load_variables
    from infomax3d_tpu_torch.losses import get_loss
    from infomax3d_tpu_torch.models.registry import build_model as registered
    from infomax3d_tpu_torch.train import flavours
    from infomax3d_tpu_torch.train.optim import (OptimizerSet, build_adam,
                                                 label_params)
    dev = torch.device(dev)
    args = _s19_args(kind, bf16)
    if kind in SLICE19_SUPERVISED:
        return build_supervised_step(args, dev)
    base = build_step(args, dev)
    if kind != "phil":
        cls = flavours.NoisyNegativesStep if kind == "noisy" else \
            flavours.AlternatingStep
        return cls.from_modules(base.model, base.model3d, dev,
                                base.compute_dtype, base.loss_fn,
                                base.optimizer)
    width = args["model3d_parameters"]["target_dim"]
    critic = load_variables(
        registered("Critic", SLICE19_CRITIC, in_dim=width),
        dict(zip(("params", "batch_stats"), init_jax_variables(
            dict(SLICE19_CRITIC, in_dim=width), 2, "Critic"))))
    models = {"model": base.model, "model3d": base.model3d,
              "critic": critic}
    opts = OptimizerSet({k: build_adam(
        [(f"{k}.{n}", p) for n, p in m.named_parameters()],
        labels=label_params({f"{k}.{n}": f"{k}/{p}" for n, p in
                             flax_paths(m).items()})[0],
        **args["optimizer_params"]) for k, m in models.items()})
    return flavours.PhilosophyStep.from_modules(
        base.model, base.model3d, critic, dev, base.compute_dtype,
        base.loss_fn, get_loss("CriticLoss"), opts)


def _s19_batch(kind: str, dev, batch_size: int):
    """`kind`'s batches on `dev` and their sizes: the labelled CSR batch,
    or the 2D batch and the CSR complete graphs (with noisy negatives the
    noised copy too, `noised_distances_collate`), QM9-size molecules."""
    from infomax3d_tpu_torch.data.loader import (noised_distances_collate,
                                                 to_device)
    if kind in SLICE19_SUPERVISED:
        g, sizes = labelled_batch(batch_size, 1, device=dev, **_QM9)
        return (g,), sizes
    if kind != "noisy":
        g2, g3, sizes = conformer_batches(batch_size, 1, device=dev, **_QM9)
        return (g2, g3), sizes
    ds = SyntheticMolecules(batch_size, **_QM9)
    items = [{"graph2d": ds.graph2d(i), "graph3d": ds.graph3d(i)}
             for i in range(batch_size)]
    view = noised_distances_collate(items, bucket_for(
        [it["graph2d"] for it in items], batch_size))
    batches = tuple(to_device(view[k], dev)
                    for k in ("graph2d", "graph3d", "noisy3d"))
    return batches, {"graphs": batch_size,
                     "edges_2d": int(batches[0].csr_row_ptr[-1]),
                     "edges_3d": int(batches[1].csr_row_ptr[-1])}


def _s19_models(kind: str, step) -> dict:
    if kind in SLICE19_SUPERVISED:
        return {"model": step.model}
    out = {"model": step.model, "model3d": step.model3d}
    if kind == "phil":
        out["critic"] = step.critic
    return out


def _s19_kw(kind: str) -> dict:
    return {"even": kind != "alt_odd"} if kind.startswith("alt") else {}


def _s19_one_step(kind: str, g, bf16: bool, dev: str, perturb: float = 0.0):
    step = _s19_step(kind, bf16, dev)
    batches = tuple(t.to(dev) for t in g)
    prepared = (step.prepare(*batches),) if kind in SLICE19_SUPERVISED \
        else step.prepare(*batches)
    return _measure_step(step, _s19_models(kind, step), prepared,
                         perturb=perturb, **_s19_kw(kind))


def _s19_sides(kind: str) -> tuple:
    """The models a step of `kind` trains (the alternating step's other
    side gets zero gradients by design)."""
    return {"alt_even": ("model",), "alt_odd": ("model3d",),
            "phil": ("model", "model3d", "critic")}.get(
                kind, ("model",) if kind in SLICE19_SUPERVISED
                else ("model", "model3d"))


def _s19_launches(kind: str, step: bool) -> dict:
    """Launches per bf16 training step (`step`) or eval forward of `kind`.
    PNA: per layer the edge combine (row 6) and the statistics (row 2),
    backwards rows 5 and 8; the flat Net3D per layer rows 6 and 7 (the
    mean), backward row 5, twice with noisy negatives.  The alternating
    step runs the backward of the side that learns.  PNARandom runs float32
    activations under the recipe (its float32 noise columns promote): per
    layer rows 6 and 1, backward row 5; PNARandomEdgeUpdate per layer row
    1 and its gathers' backwards rows 4 and 3.  The critic runs none."""
    a = _s19_args(kind, True)
    L = a["model_parameters"]["propagation_depth"]
    if kind == "pnar":
        out = dict(NONE, edge_combine=L, multi_reduce=L)
        return dict(out, pair_segment_sum=L) if step else out
    if kind == "pner":
        out = dict(NONE, multi_reduce=L)
        return dict(out, snd_segment_sum=L, csr_segment_sum=L) if step \
            else out
    if kind == "pair":
        out = dict(NONE, edge_combine=L, pna_stats=L)
        return dict(out, pair_segment_sum=L, pna_stats_bwd=L) if step \
            else out
    d3 = a["model3d_parameters"]["propagation_depth"] * (
        2 if kind == "noisy" else 1)
    out = dict(NONE, edge_combine=L + d3, pna_stats=L, csr_sum=d3)
    if not step:
        return out
    learns2, learns3 = kind != "alt_odd", kind != "alt_even"
    return dict(out, pair_segment_sum=L * learns2 + d3 * learns3,
                pna_stats_bwd=L * learns2)


def _patch(obj, name: str, new):
    """Set `obj.name` to `new`; returns the undo."""
    real = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, real)


def _philosopher_sign():
    """(phil)'s planted fault: the philosopher loss peasant + critic."""
    from infomax3d_tpu_torch.train import flavours
    real = flavours.PhilosophyStep.loss

    def loss(self, *a, **kw):
        peasant, out = real(self, *a, **kw)
        out[2]["philosopher_loss"] = peasant + out[2][self.critic_loss_name]
        return peasant, out
    return _patch(flavours.PhilosophyStep, "loss", loss)


def _parity_swapped():
    """(alt_odd)'s planted fault: the odd step run as an even one."""
    from infomax3d_tpu_torch.train import flavours
    real = flavours.AlternatingStep.loss
    return _patch(flavours.AlternatingStep, "loss",
                  lambda self, *a, even=True, **kw: real(
                      self, *a, even=not even, **kw))


def _extra_negatives_dropped():
    """(noisy)'s planted fault: the loss without the noised copy's
    embeddings."""
    from infomax3d_tpu_torch.train import flavours

    def loss(self, g2, g3, noisy, noise=None):
        z1, z2 = self.outputs(g2, g3, noise)
        return self.loss_fn(z1, z2), (z1, z2)
    return _patch(flavours.NoisyNegativesStep, "loss", loss)


def _distance_column_dropped():
    """(pair)'s planted fault: every edge's coordinates read at node 0, so
    the squared-distance column is 0.  (A sender / receiver swap is no
    fault: the squared distance is symmetric.)"""
    from infomax3d_tpu_torch.models import pna
    real = pna.take_clipped
    return _patch(pna, "take_clipped",
                  lambda x, idx: real(x, torch.zeros_like(idx)))


SLICE19_FAULTS = {"phil": {"philosopher sign": _philosopher_sign},
                  "alt_odd": {"parity swapped": _parity_swapped},
                  "noisy": {"extra negatives dropped":
                            _extra_negatives_dropped},
                  "pair": {"distance column dropped":
                           _distance_column_dropped}}


def _s19_checks(kinds: tuple = SLICE19_KINDS):
    """One float32 and one bf16 step of each kind on the card against the
    CPU's float32 step (`_hold_step_against_cpu`, the models the step
    trains; the CPU's own bf16 distance the largest of SLICE18_WITNESSES
    readings), and each planted fault against the bf16 check."""
    for kind in kinds:
        g, sizes = _s19_batch(kind, "cpu", SLICE19_CHECK)
        print(f"[slice19] ({kind}) {SLICE19_NAMES[kind]}: the step on "
              f"{SLICE19_CHECK} graphs ({sizes}), card against CPU")
        _hold_step_against_cpu(
            lambda bf16, dev, perturb=0.0: _s19_one_step(kind, g, bf16, dev,
                                                         perturb),
            _s19_sides(kind), SLICE19_FAULTS.get(kind, {}),
            f"slice19 ({kind})", SLICE19_ZERO,
            witnesses=SLICE18_WITNESSES,
            f32_witnesses=SLICE19_F32_WITNESSES.get(kind, 0))


def _s19_kernels(g2, g3) -> dict:
    """Every kernel of the slice's paths bit for bit at its new call
    sites, at the pre-training batch (500 molecules): on the bond graphs
    at the PNA width (200) rows 6 and 5 (bf16 and float32: PNARandom's
    float32 combine, the pairwise-distance PNA's bf16 one), 2 and 8, 1
    (the float32 aggregates of PNARandom and the edge-update layers) and
    the edge-update layers' gather backwards, rows 4 and 3; on the
    complete graphs at the Net3D width (20) rows 6, 5 and 7."""
    gen = torch.Generator(device="cuda").manual_seed(260)
    a = _s19_args("phil", True)
    w, w3 = a["model_parameters"]["hidden_dim"], a["model3d_parameters"][
        "hidden_dim"]
    pairs = {"edge_combine": [], "pair_segment_sum": [], "csr_sum": []}
    for tag, g, width in (("bonds", g2, w), ("complete graphs", g3, w3)):
        pairs["edge_combine"] += _hold_edge_combine(f"slice19 {tag}", gen, g,
                                                    (width,))
        pairs["pair_segment_sum"] += _hold_pair_segment_sum(
            f"slice19 {tag}", gen, g, (width,))
    pairs["csr_sum"] += _hold_csr_sum("slice19 complete graphs", gen, g3,
                                      (w3,))
    errs = {n: _max_err(p) for n, p in pairs.items()}
    E = g2.senders.shape[0]
    cases = [("bonds", g2.csr_row_ptr, g2.max_deg, E, w)]
    errs["pna_stats"] = _max_err(_hold_pna_stats("slice19", gen, cases))
    errs["pna_stats_bwd"] = _max_err(_hold_pna_stats_bwd("slice19", gen,
                                                         cases))
    _merge_errs(errs, _hold_walks(
        "slice19", gen, [("bonds", g2.csr_row_ptr, g2.max_deg, E, (w,))],
        [("bonds", g2.csc_row_ptr, g2.csc_perm, E, (w,))],
        [("bonds", g2.csr_row_ptr, E, (w,))]))
    return errs


def _s19_timed(smi: str):
    """Each kind's bf16 step at the config's batch (500): launches per step
    (exact), ms per step (CUDA events over warm steps), graphs/s, peak
    memory, kernels per step and the idle share of a profiled step."""
    from torch.profiler import ProfilerActivity, profile
    bs = _s19_config()["batch_size"]
    for kind in SLICE19_KINDS:
        step = _s19_step(kind, True, "cuda")
        g, sizes = _s19_batch(kind, "cuda", bs)
        gp = (step.prepare(*g),) if kind in SLICE19_SUPERVISED \
            else step.prepare(*g)

        def one():
            return step.step(*gp, **_s19_kw(kind))
        _reset_counts()
        loss = float(one())
        per, want = _counts(), _s19_launches(kind, True)
        _check(per == want and np.isfinite(loss),
               f"({kind}) launches per step {per} != {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(one, iters=SLICE19_TIMED, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        by_name = _profile_kernels(prof)
        kernels = sum(c for _, c in by_name.values())
        busy = sum(us for us, _ in by_name.values()) / 1e3
        print(f"[slice19] ({kind}) {SLICE19_NAMES[kind]}, bf16, batch {bs}: "
              f"{ms:.3f} ms per step (CUDA events over {SLICE19_TIMED} warm "
              f"steps), {bs / ms * 1e3:.1f} graphs/s, peak "
              f"max_memory_allocated {peak:.3f} GiB, {kernels} kernels per "
              f"step, device busy {busy:.3f} ms of the profiled step (idle "
              f"share {max(1 - busy / ms, 0.0):.3f}); launches per step "
              f"(exact) { {n: c for n, c in per.items() if c} }; batch "
              f"{sizes}; {smi}")
        for kname, (us, c) in _port_kernels(by_name).items():
            print(f"[slice19] ({kind})   {kname}: {c} launches, "
                  f"{us / c:.2f} us each in the step")
        del step, gp


# the CLI runs: a synthetic QM9 cache (19 targets) and a `qm9_geomol` one of
# float features; 1 epoch each: philosophy at the config's batch (2 steps
# of 500), the GeoMol fine-tune at its batch (4 steps of 128)
SLICE19_CACHES = {"QM9": dict(num=1500, num_targets=19, seed=7, n_min=4,
                              n_max=26),
                  "qm9_geomol": dict(num=1000, num_targets=19, seed=8,
                                     n_min=4, n_max=26, float_features=True)}
SLICE19_PHIL = dict(_S18_CLI, num_train=1000, num_val=500,
                    trainer="philosophy", critic_type="Critic",
                    critic_parameters=SLICE19_CRITIC,
                    critic_loss="CriticLoss")
SLICE19_GEOMOL = "configs/tune_from_ot_geomoL_feat.yml"
SLICE19_TUNE = dict(_S18_CLI, num_train=512, num_val=128,
                    pretrain_checkpoint=None)


def _s19_cli(out_dir: Path, caches: Path) -> dict:
    """The philosophy trainer through `cli.train.train` on
    configs_clean/pre-train_QM9.yml (the critic in the checkpoint with the
    three optimizers, the three losses logged, finite; the launches
    exact), then `configs/tune_from_ot_geomoL_feat.yml` without its
    `pretrain_checkpoint` and again from the first run's checkpoint (its
    ``gnn.`` transfer moves nothing, as in the JAX CLI: both rename the
    source's root ``gnn.`` to ``node_gnn.``).  Returns the launches (the
    main path)."""
    from infomax3d_tpu_torch.cli import train as cli
    from infomax3d_tpu_torch.train import checkpoint
    _reset_counts()
    with mock.patch.dict(os.environ, {"INFOMAX3D_DATA": str(caches)}):
        run = _data_run(SLICE19_CONFIG, SLICE19_PHIL,
                        out_dir / "slice19_phil", TRAINER_DEVICE,
                        unbounded=("uniformity",))
        payload = checkpoint.load_checkpoint(str(run["dir"] /
                                                 "best_checkpoint.pt"))
        _check(set(payload["optimizer_state_dict"]) ==
               {"model", "model3d", "critic"} and
               "critic_state_dict" in payload,
               "philosophy: the checkpoint lacks the critic or an optimizer")
        recs = [json.loads(x) for x in open(run["dir"] / "metrics.jsonl")]
        train = [r for r in recs if r["split"] == "train"]
        val = [r for r in recs if r["split"] == "val"]
        names = ("NTXent", "philosopher_loss", "CriticLoss")
        _check(len(train) > 0 and len(val) == 1 and all(
            np.isfinite(r[n]) for r in train + val for n in names),
            f"philosophy CLI losses {train}, validation {val}")
        args = run["args"]
        _, v, t = cli.make_splits(args, cli.build_dataset(args))
        bs = args["batch_size"]
        evals = (args["num_epochs"] + 1) * (len(v) // bs) + (
            len(t) // bs if args["eval_on_test"] and len(t) else 0)
        L = args["model_parameters"]["propagation_depth"]
        fwd = dict(NONE, edge_combine=L, pna_stats=L)
        want = _expect(dict(fwd, pair_segment_sum=L, pna_stats_bwd=L), fwd,
                       len(train), evals)
        _check(run["launches"] == want,
               f"philosophy CLI launches {run['launches']} != {want}")
        timing = json.load(open(run["dir"] / "timing.json"))
        print(f"[slice19] philosophy CLI {SLICE19_CONFIG} (QM9 cache, "
              f"Net3DDense on the dense 3D batch, 1 epoch of {len(train)} "
              f"steps at batch {bs}): {run['wall_s']:.1f} s, losses "
              + "; ".join(f"{n} {[round(r[n], 4) for r in train]}"
                          for n in names)
              + f", validation {[round(val[0][n], 4) for n in names]}, "
              f"step ms {[round(x, 2) for x in timing['step_ms']]}; "
              f"launches { {n: c for n, c in run['launches'].items() if c} }")
        first = _data_run(SLICE19_GEOMOL, SLICE19_TUNE,
                          out_dir / "slice19_tune", TRAINER_DEVICE)
        ckpt = first["dir"] / "best_checkpoint.pt"
        second = _data_run(SLICE19_GEOMOL, dict(SLICE19_TUNE,
                                                pretrain_checkpoint=str(ckpt)),
                           out_dir / "slice19_tune2", TRAINER_DEVICE)
        _check("transferred 0 parameter tensors" in second["text"],
               "tune_from_ot_geomoL_feat: the transfer moved weights the "
               "JAX CLI does not move")
        for tag, r in (("scratch", first), ("from the first run", second)):
            print(f"[slice19] {SLICE19_GEOMOL} ({tag}; qm9_geomol cache of "
                  f"float features, node_dim / edge_dim read off the data): "
                  f"{r['wall_s']:.1f} s, L1Loss "
                  f"{r['result']['L1Loss']:.4f}, launches "
                  f"{ {n: c for n, c in r['launches'].items() if c} }")
    launches = _counts()
    print(f"[slice19] main-path launches (the CLI runs): {launches}")
    return launches


def _write_slice19_caches(root: Path) -> Path:
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    for name, kw in SLICE19_CACHES.items():
        write_synthetic_cache(str(root / name / "processed.npz"), **kw)
    return root


def phase_slice19(smi: str, out_dir: Path) -> dict:
    """Phase 26: the philosophy, alternating and noisy-negatives trainers,
    PNARandom, PNARandomEdgeUpdate and PNA's pairwise distances at the
    pre-training architecture, and the last config through the CLI.
    Returns the main path's launches (the CLI runs) and the kernel
    checks' errors."""
    t = [time.perf_counter()]
    (g2, g3), _ = _s19_batch("phil", "cuda", _s19_config()["batch_size"])
    errs = _s19_kernels(g2, g3)
    del g2, g3
    t.append(time.perf_counter())
    _s19_checks()
    t.append(time.perf_counter())
    _s19_timed(smi)
    t.append(time.perf_counter())
    caches = _write_slice19_caches(out_dir / "slice19_caches")
    launches = _s19_cli(out_dir, caches)
    t.append(time.perf_counter())
    print("[slice19] seconds: " + ", ".join(
        f"{k} {b - a:.1f}" for k, a, b in zip(
            ("kernel checks", "step checks", "timings", "CLI runs"),
            t, t[1:])))
    return {"launches": launches, "errs": errs}


# ------------------------------------------------ phase 27: data parallel

# configs_clean/pre-train_QM9.yml's step (phase 8) and configs/30.yml's GIN
# step (phase 12) with `n_shards: 2`: each rank takes its half of the
# batch (250 and 64 molecules), both ranks on the one card over gloo
# (named: NCCL refuses two ranks on one card).  The ranks build what
# `spec` says (`_dp_spec`), so that a rehearsal can shrink it.
DP_RANKS = 2
DP_TIMED = 5
# (c): 1 epoch of 2 steps of 500 (250 per rank), one validation batch and
# the best checkpoint's, on 5000 synthetic molecules
DP_CLI = {"dataset": "synthetic", "dataset_params": {"num": 5000},
          "num_train": 1000, "num_epochs": 1, "eval_on_test": False,
          "use_tensorboard": False, "log_iterations": 1,
          "n_shards": DP_RANKS, "dist_backend": "gloo"}
DP_CLI_STEPS, DP_CLI_EVALS = 2, 2
DP_FAULTS = ("BatchNorm statistics local", "loss on local rows",
             "gradients summed")
DP_SIDES = {"pre": ("model", "model3d"), "gin": ("model",)}


def _dp_spec() -> dict:
    return {"device": "cuda", "ranks": DP_RANKS, "backend": "gloo",
            "timed": DP_TIMED,
            "pre": {bf16: _train_args(bf16) for bf16 in (False, True)},
            "gin": {bf16: _gin_args(bf16) for bf16 in (False, True)},
            "pre_data": {"seed": 0, "n_min": DATA["n_min"],
                         "n_max": DATA["n_max"]},
            "gin_data": GIN_DATA, "cli": (TRAINER_PRE, DP_CLI),
            "expect": {("pre", False): EXPECTED_STEP[False],
                       ("pre", True): EXPECTED_STEP[True],
                       ("gin", False): EXPECTED_GIN_STEP,
                       ("gin", True): EXPECTED_GIN_STEP,
                       "cli": _expect(EXPECTED_STEP[True], EXPECTED[True],
                                      DP_CLI_STEPS, DP_CLI_EVALS)}}


def _dp_batches(spec: dict, rank: int, k: int, device) -> dict:
    """Shard `rank` of `k` of phase 8's flagship batch (the CSR 2D batch
    and the dense 3D batch on the whole batch's largest molecule) and of
    phase 12's GIN batch; the whole batches for k = 1."""
    from infomax3d_tpu_torch.graphs.dense import dense_batch, to_dense_batch
    n, d = spec["pre"][True]["batch_size"], spec["pre_data"]
    ds = SyntheticMolecules(n, **d)
    per = n // k
    idx = range(rank * per, (rank + 1) * per)
    mols2 = [ds.graph2d(i) for i in idx]
    mols3 = [ds.graph3d(i) for i in idx]
    nmax3 = max(ds.graph3d(i)["node_feat"].shape[0] for i in range(n))
    b2 = bucket_for(mols2, per)
    gn = spec["gin"][True]["batch_size"]
    gds = SyntheticMolecules(gn, num_targets=1, **spec["gin_data"])
    labels = (gds.targets > 0).astype(np.float32)
    per_g = gn // k
    mols = [dict(gds.graph2d(i), targets=labels[i])
            for i in range(rank * per_g, (rank + 1) * per_g)]
    bg = bucket_for(mols, per_g)
    return {"pre": (to_graph_batch(batch_graphs(mols2, b2), b2, device),
                    to_dense_batch(dense_batch(mols3, per, nmax3), device)),
            "gin": (to_graph_batch(batch_graphs(mols, bg), bg, device),)}


# what wraps the contrastive loss under a group (a planted fault swaps it)
_DP_LOSS = {"wrap": None}
# each process's steps by (kind, bf16): built once (a PNA 200x7 step takes
# seconds to build), their weights and statistics restored for each use
_DP_STEPS = {}


def _dp_fresh(spec: dict, kind: str, bf16: bool, dev):
    """The seeded step of `kind` ("pre", "gin") at its initial weights and
    running statistics, its models and its own loss."""
    key = (kind, bf16)
    if key not in _DP_STEPS:
        if kind == "pre":
            step = build_step(spec["pre"][bf16], dev)
            models = {"model": step.model, "model3d": step.model3d}
        else:
            step = build_supervised_step(spec["gin"][bf16], dev)
            models = {"model": step.model}
        state = {n: {k: v.clone() for k, v in m.state_dict().items()}
                 for n, m in models.items()}
        _DP_STEPS[key] = (step, models, state, getattr(step, "loss_fn",
                                                       None))
    step, models, state, loss = _DP_STEPS[key]
    for n, m in models.items():
        m.load_state_dict(state[n])
    if loss is not None:
        step.loss_fn = loss
    return step, models


def _dp_step(spec: dict, kind: str, bf16: bool, batches, group,
             perturb: float = 0.0, timed: bool = False):
    """`_measure_step` of one seeded step of `kind` ("pre", "gin") on
    `batches` under the data-parallel `group` (the contrastive loss
    through `CrossDeviceLoss`), or in one process with None; with
    `timed`, ms per step instead (CUDA events over `spec["timed"]` warm
    steps, which move the step's weights: the last use of its step)."""
    from infomax3d_tpu_torch.parallel import CrossDeviceLoss, using_groups
    step, models = _dp_fresh(spec, kind, bf16, batches[0].node_feat.device)
    if group is not None and kind == "pre":
        wrap = _DP_LOSS["wrap"] or CrossDeviceLoss
        step.loss_fn = wrap(step.loss_fn, group)
    prepared = step.prepare(*batches)
    if not isinstance(prepared, tuple):
        prepared = (prepared,)
    with using_groups(data=group):
        if timed:
            return cuda_ms(lambda: step.step(*prepared),
                           iters=spec["timed"], warmup=1)
        return _measure_step(step, models, prepared, perturb=perturb)


def _dp_sum_over_ranks(tensors, group):
    """The gradient mean without its division (a planted fault)."""
    from infomax3d_tpu_torch.parallel.collectives import all_reduce_
    for t in tensors:
        all_reduce_(t, group)
    return list(tensors)


def _dp_plant(name: str):
    """Plant the data-parallel fault `name` in this process (BatchNorm
    statistics left local; the contrastive loss on the local rows; the
    gradients summed over the ranks, not averaged); returns the undo."""
    if name == "loss on local rows":
        _DP_LOSS["wrap"] = lambda loss, group: loss
        return lambda: _DP_LOSS.update(wrap=None)
    mod, attr, fake = {
        "BatchNorm statistics local": (
            "infomax3d_tpu_torch.models.base", "step_group",
            lambda: None),
        "gradients summed": ("infomax3d_tpu_torch.train.supervised",
                             "mean_over_ranks", _dp_sum_over_ranks)}[name]
    mod = importlib.import_module(mod)
    real = getattr(mod, attr)
    setattr(mod, attr, fake)
    return lambda: setattr(mod, attr, real)


def _dp_collectives(spec: dict, kind: str, batches, group) -> dict:
    """The collectives of one bf16 step of `kind` under `group`: per kind
    (all-reduce, all-gather) the calls, the elements and the host ms
    between a synchronization before and one after each."""
    from infomax3d_tpu_torch.parallel import collectives as C
    seen = {"all_reduce": [0, 0, 0.0], "all_gather": [0, 0, 0.0]}
    real = {"all_reduce_": C.all_reduce_, "gather_rows": C.gather_rows}
    cuda = spec["device"] == "cuda"

    def timed(name, key):
        def fn(t, group):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](t, group)
            if cuda:
                torch.cuda.synchronize()
            s = seen[key]
            s[0] += 1
            s[1] += t.numel()
            s[2] += (time.perf_counter() - t0) * 1e3
            return out
        return fn
    C.all_reduce_ = timed("all_reduce_", "all_reduce")
    C.gather_rows = timed("gather_rows", "all_gather")
    try:
        _dp_step(spec, kind, True, batches, group)
    finally:
        C.all_reduce_, C.gather_rows = real["all_reduce_"], \
            real["gather_rows"]
    return seen


def _dp_rank(rank: int, spec: dict, out: str, port: int):
    """One rank of phase 27 (b) and (c): the steps on its shards under the
    group (`spec["backend"]`, rendezvous in a file store), each step's
    launches, the
    planted faults, the collectives and the timings; then (c), the CLI as
    torchrun starts it (the launch in the environment, rendezvous on
    localhost).  Writes its results to `out`/rank{rank}.pt."""
    from datetime import timedelta
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import train as cli_train
    from infomax3d_tpu_torch.parallel import close_group, make_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k, res = spec["ranks"], {}
    group, dev = make_group(k, rank, f"file://{out}/store", spec["backend"],
                            spec["device"], timeout=timedelta(minutes=5))
    try:
        batches = _dp_batches(spec, rank, k, dev)
        _reset_counts()
        for kind in ("pre", "gin"):
            for bf16 in (False, True):
                before = _counts()
                res[(kind, bf16)] = _dp_step(spec, kind, bf16,
                                             batches[kind], group)
                res[(kind, bf16, "launches")] = {
                    n: c - before[n] for n, c in _counts().items()}
        res["launches"] = _counts()
        for name in DP_FAULTS:
            undo = _dp_plant(name)
            try:
                res[("fault", name)] = _dp_step(spec, "pre", False,
                                                batches["pre"], group)
            finally:
                undo()
        for kind in ("pre", "gin"):
            res[(kind, "collectives")] = _dp_collectives(
                spec, kind, batches[kind], group)
            if spec["device"] == "cuda":
                res[(kind, "ms")] = _dp_step(spec, kind, True, batches[kind],
                                             group, timed=True)
    finally:
        close_group()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(k),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(k))
    config, overrides = spec["cli"]
    args = load_config(config, dict(overrides, logdir=f"{out}/cli"))
    _reset_counts()
    t0 = time.perf_counter()
    res["cli"] = cli_train(args, device=spec["device"])
    res["cli_s"] = time.perf_counter() - t0
    res["cli_launches"] = _counts()
    torch.save(res, f"{out}/rank{rank}.pt")


def _dp_same(a, b) -> bool:
    """Two `_measure_step` results equal bit for bit."""
    return a[0] == b[0] and a[1].keys() == b[1].keys() and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for x, y in ((a[1][k], b[1][k]) for k in a[1]))


def _dp_one_rank(spec: dict, whole: dict, out: Path) -> dict:
    """(a) The bf16 pre-training step through a one-rank NCCL group, bit
    for bit the step without a group; returns the group step's
    launches."""
    from infomax3d_tpu_torch.parallel import close_group, make_group
    store = out / "dp_one_rank_store"
    store.unlink(missing_ok=True)
    make_group(1, 0, f"file://{store}",
               "nccl" if spec["device"] == "cuda" else "gloo",
               spec["device"])
    try:
        import torch.distributed as dist
        group = dist.group.WORLD
        alone = _dp_step(spec, "pre", True, whole["pre"], None)
        before = _counts()
        grouped = _dp_step(spec, "pre", True, whole["pre"], group)
        launches = {n: c - before[n] for n, c in _counts().items()}
        backend = dist.get_backend(group)
    finally:
        close_group()
    _check(_dp_same(alone, grouped),
           "the step through a one-rank group is not the step without one")
    _check(launches == spec["expect"][("pre", True)],
           f"(a) launches {launches}")
    print(f"[dp] (a) bf16 pre-training step through a one-rank {backend} "
          f"group: loss {grouped[0]:.6f}, loss, every gradient and running "
          f"statistic bit for bit the step without a group")
    return launches


def _dp_limits(spec: dict, kind: str, whole: dict) -> tuple:
    """The one-process steps on the whole batch (float32, bf16) and the
    bf16 check's limits: `_bf16_limits` of the largest distance of two
    witnesses (the bf16 step at weights scaled by 1 + j * 2^-16 U(-1, 1),
    j = 1, 2, against the bf16 step at the seeded weights)."""
    f32 = _dp_step(spec, kind, False, whole[kind], None)
    b16 = _dp_step(spec, kind, True, whole[kind], None)
    own, own_loss = None, 0.0
    for j in (1, 2):
        lw, w = _dp_step(spec, kind, True, whole[kind], None,
                         perturb=j * 2.0 ** -16)
        rw = _readings(w, b16[1], DP_SIDES[kind])
        own_loss = max(own_loss, abs(lw - b16[0]) / abs(b16[0]))
        if own is None:
            own = rw
        else:
            _merge_own(own, rw)
    _print_readings(f"({kind}) bf16 witnesses vs bf16 one process", own,
                    {s: d["l2"] for s, d in own.items()}, "dp")
    return f32, b16, _bf16_limits(own, own_loss)


def _dp_held(got, ref, sides, tol, l2_tol, leaf_tol=None) -> tuple:
    r = _readings(got[1], ref[1], sides)
    rel = abs(got[0] - ref[0]) / abs(ref[0])
    bad = ([f"loss {rel:.3g}"] if rel > tol["loss"] else []) + \
        _violations(r, tol, l2_tol, leaf_tol)
    return r, rel, bad


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_data_parallel(smi: str, out_dir: Path, spec: dict = None) -> dict:
    """Phase 27: data parallelism (`n_shards: 2`).  (a) the bf16
    pre-training step through a one-rank NCCL group, bit for bit the step
    without one; (b) two ranks on the card over gloo: the pre-training
    and GIN steps (float32, bf16) on their halves of the batch against
    one process on the whole batch on the card, float32 within STEP_TOL,
    bf16 within `_bf16_limits` of the bf16 step's own rounding witnesses,
    the ranks bit-equal, launches per step exact; three planted faults
    that must each fail the float32 check; the collectives per step and
    the ms per step of two ranks time-sliced on one card; (c) the CLI,
    `pre-train_QM9.yml` with `n_shards: 2` through torchrun's launch
    environment.  Returns the main path's launches ((a), the ranks' steps
    and CLI runs)."""
    import shutil
    spec = spec or _dp_spec()
    k = spec["ranks"]
    t = [time.perf_counter()]
    whole = _dp_batches(spec, 0, 1, torch.device(spec["device"]))
    _reset_counts()
    launches = _dp_one_rank(spec, whole, out_dir)
    t.append(time.perf_counter())
    refs = {kind: _dp_limits(spec, kind, whole) for kind in ("pre", "gin")}
    one_ms = {kind: _dp_step(spec, kind, True, whole[kind], None, timed=True)
              for kind in ("pre", "gin") if spec["device"] == "cuda"}
    t.append(time.perf_counter())
    run = out_dir / "data_parallel"
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir(parents=True)
    torch.multiprocessing.start_processes(
        _dp_rank, args=(spec, str(run), _free_port()), nprocs=k,
        start_method="spawn")
    ranks = [torch.load(run / f"rank{r}.pt", weights_only=False)
             for r in range(k)]
    t.append(time.perf_counter())
    for kind in ("pre", "gin"):
        f32, b16, limits = refs[kind]
        for bf16 in (False, True):
            got = ranks[0][(kind, bf16)]
            _check(all(_dp_same(got, r[(kind, bf16)]) for r in ranks[1:]),
                   f"({kind}, bf16={bf16}) the ranks differ")
            for r in ranks:
                per = r[(kind, bf16, "launches")]
                _check(per == spec["expect"][(kind, bf16)],
                       f"({kind}, bf16={bf16}) launches per rank {per}")
            held = limits if bf16 else (
                STEP_TOL[False], {s: STEP_TOL[False]["l2"]
                                  for s in DP_SIDES[kind]})
            r, rel, bad = _dp_held(got, b16 if bf16 else f32,
                                   DP_SIDES[kind], *held)
            print(f"[dp] (b) {kind} bf16={bf16}: {k} ranks "
                  f"({spec['backend']}) vs one process "
                  f"on the whole batch: loss {got[0]:.6f} vs "
                  f"{(b16 if bf16 else f32)[0]:.6f}, {rel:.3g} (tol "
                  f"{held[0]['loss']:.3g}); the ranks bit-equal")
            _print_readings(f"({kind}) bf16={bf16} {k} ranks vs one process",
                            r, held[1], "dp")
            _check(not bad, f"({kind}, bf16={bf16}) {k} ranks vs one "
                            f"process: {bad}")
    f32 = refs["pre"][0]
    for name in DP_FAULTS:
        r, rel, bad = _dp_held(ranks[0][("fault", name)], f32,
                               DP_SIDES["pre"], STEP_TOL[False],
                               {s: STEP_TOL[False]["l2"]
                                for s in DP_SIDES["pre"]})
        print(f"[dp] (d) planted fault ({name}), float32: loss {rel:.3g}, "
              f"{len(bad)} violations, e.g. {bad[:2]}")
        _check(bool(bad), f"the data-parallel check passed a planted fault "
                          f"({name})")
    for kind in ("pre", "gin"):
        seen = ranks[0][(kind, "collectives")]
        how = ("gloo, host-staged" if spec["backend"] == "gloo"
               else spec["backend"])
        print(f"[dp] ({kind}) collectives of one bf16 step per rank: "
              + ", ".join(f"{n} {c} calls of {e} elements in all, {ms:.3f} "
                          f"ms host ({how}, synchronized)"
                          for n, (c, e, ms) in seen.items()))
        if (kind, "ms") in ranks[0]:
            where = ("time-sliced on one card" if torch.cuda.device_count()
                     < k else "one card each")
            print(f"[dp] ({kind}) {k} ranks {where}, {spec['backend']}: "
                  f"{ranks[0][(kind, 'ms')]:.3f} ms per bf16 step (rank 0's "
                  f"CUDA events over {spec['timed']} warm steps); one "
                  f"process on the whole batch {one_ms[kind]:.3f} ms"
                  + ("; not a measure of data-parallel speed"
                     if where != "one card each" else "") + f"; {smi}")
    results = [r["cli"] for r in ranks]
    _check(all(res == results[0] for res in results[1:]),
           "(c) the ranks' CLI results differ")
    _check(all(np.isfinite(v) for v in results[0].values()),
           f"(c) non-finite metrics {results[0]}")
    cli_dir = _run_dir(run / "cli")
    for name in ("best_checkpoint.pt", "last_checkpoint.pt",
                 "train_arguments.yaml", "metrics.jsonl", "timing.json",
                 "evaluation_val_best_checkpoint.txt"):
        _check((cli_dir / name).exists(), f"(c) no {name}")
    for r in ranks:
        _check(r["cli_launches"] == spec["expect"]["cli"],
               f"(c) launches per rank {r['cli_launches']}")
    loss_key = next(key for key in results[0] if "NTXent" in key)
    print(f"[dp] (c) CLI {spec['cli'][0]} with n_shards {k} (torchrun's "
          f"environment, {spec['cli'][1]['dist_backend']}): "
          f"{ranks[0]['cli_s']:.1f} s, {loss_key} "
          f"{results[0][loss_key]:.6f}, the ranks' results equal")
    for r in ranks:
        for n in NONE:
            launches[n] += r["launches"][n] + r["cli_launches"][n]
    _DP_CACHE.update(refs=refs, ranks=ranks)
    t.append(time.perf_counter())
    print(f"[dp] data-parallel main-path launches: {launches}")
    print("[dp] seconds: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(
            ("(a) one-rank group", "one-process references",
             "the ranks (b, c)", "checks"), t, t[1:])))
    return {"launches": launches}

# ----------------------- phase 28: remat, the non-CSR batch, the partitions

S21_TIMED = 5
# (c)'s timed steps: two ranks time-sliced on one card, ~1.8 s an edge-mode
# step (NVIDIA H100 80GB HBM3, 700 W), so fewer
S21_PART_TIMED = 3
# launches per QMugs bf16 step with remat: the step's, plus one more
# forward's (the recompute runs every forward kernel again)
EXPECTED_REMAT_STEP = {n: EXPECTED_CONF_STEP[True][n]
                       + EXPECTED_CONF_FWD[True][n] for n in NONE}
S21_RANKS = 2
S21_FAULTS = ("edge aggregation not completed", "halo backward dropped",
              "BatchNorm not over the graph group")
S21_MODES = {"edge": ("edge aggregation not completed",),
             "node": ("halo backward dropped",
                      "BatchNorm not over the graph group")}
# the running statistics of a partitioned float32 step: rows whole on every
# rank of the group (node-space rows in edge mode, the readout MLP's graph
# rows in both) count k times in the unbiased correction count / (count -
# 1), as in the JAX package; edge mode within the JAX package's own bound
# (tests/test_edge_partition_mode.py), node mode within the CPU test's
# (tests/test_torch_port_partition.py)
S21_STATS_TOL = {"edge": 1.2e-2, "node": 2e-3}
S21_SIDES = ("model", "model3d")
# (b)'s bf16 witnesses beyond the seeded weights' (`_s21_noncsr`): the
# PNA's bf16 gradient is ill-conditioned (its L2 0.3 to 0.4 from the
# float32 step's), and an edge shard's partial sums reorder every
# aggregation, which one reading at the seeded weights does not span
S21_WITNESSES = 2
# the halo check (`_s21_halo`, float64): the same sums in another order
S21_HALO_TOL = 1e-12


def _s21_spec() -> dict:
    return {"device": "cuda", "ranks": S21_RANKS, "backend": "gloo",
            "timed": S21_TIMED, "part_timed": S21_PART_TIMED,
            "batch": BATCH,
            "data": {"seed": 0, "n_min": DATA["n_min"],
                     "n_max": DATA["n_max"]},
            "flat": {bf16: dict(_train_args(bf16), model3d_type="Net3D")
                     for bf16 in (False, True)},
            "conf": _conf_args(True, CONF_QMUGS), "conf_data": CONF_DATA,
            "conf_c": CONF_CONFS[CONF_QMUGS],
            "expect": {"remat": EXPECTED_REMAT_STEP,
                       "plain": EXPECTED_CONF_STEP[True],
                       "csr": {bf16: {n: v + _NET3D_STEP.get(n, 0)
                                      for n, v in EXPECTED_STEP[bf16].items()}
                               for bf16 in (False, True)}}}


def _s21_views(spec: dict, csr: bool) -> dict:
    """Phase 8's 500 molecules as host views: the bond graphs and the
    complete graphs, each in the smallest bucket that holds it
    (`bucket_for`), with or without the CSR arrays."""
    ds = SyntheticMolecules(spec["batch"], **spec["data"])
    views = {}
    for key, mols in (("graph2d", [ds.graph2d(i) for i in range(len(ds))]),
                      ("graph3d", [ds.graph3d(i) for i in range(len(ds))])):
        b = bucket_for(mols, spec["batch"])
        if not csr:
            b = dataclasses.replace(b, csr=False, max_deg=0)
        arrays = batch_graphs(mols, b)
        arrays["max_deg"] = np.asarray(b.max_deg, np.int64)
        arrays["nmax"] = np.asarray(b.nmax, np.int64)
        views[key] = arrays
    return views


def _s21_batches(views: dict, device) -> tuple:
    from infomax3d_tpu_torch.data.loader import to_device
    return to_device(views["graph2d"], device), to_device(views["graph3d"],
                                                         device)


# each process's steps by key, built once, their state restored for each use
_S21_STEPS = {}


def _s21_fresh(args: dict, key, dev):
    """The seeded step of `args` at its initial weights and running
    statistics, with its models."""
    if key not in _S21_STEPS:
        step = build_step(args, dev)
        models = {"model": step.model, "model3d": step.model3d}
        state = {n: {k: v.clone() for k, v in m.state_dict().items()}
                 for n, m in models.items()}
        _S21_STEPS[key] = (step, models, state)
    step, models, state = _S21_STEPS[key]
    for n, m in models.items():
        m.load_state_dict(state[n])
    step.remat = False
    return step, models


def _s21_measure(spec: dict, key, batches, remat: bool = False,
                 perturb: float = 0.0, args: dict = None):
    """(`_measure_step` of one step of the step `key` from its seeded
    state, its launches)."""
    args = args or spec["flat"][key[1]]
    step, models = _s21_fresh(args, key, batches[0].node_feat.device)
    step.remat = remat
    before = _counts()
    got = _measure_step(step, models, step.prepare(*batches),
                        perturb=perturb)
    return got, {n: c - before[n] for n, c in _counts().items()}


def _s21_timed(spec: dict, key, batches, remat: bool = False,
               args: dict = None) -> dict:
    """ms per step (CUDA events over `spec["timed"]` warm steps) and the
    peak `max_memory_allocated` over one warm step; moves the step's
    weights (restored on its next use)."""
    args = args or spec["flat"][key[1]]
    step, _ = _s21_fresh(args, key, batches[0].node_feat.device)
    step.remat = remat
    prepared = step.prepare(*batches)
    step.step(*prepared)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step.step(*prepared)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"ms": cuda_ms(lambda: step.step(*prepared), iters=spec["timed"],
                          warmup=1), "peak": peak}


def _s21_remat(spec: dict, smi: str) -> dict:
    """(a) the QMugs bf16 step with and without remat."""
    dev = torch.device(spec["device"])
    g2, g3, sizes = conformer_batches(spec["batch"], spec["conf_c"],
                                      device=dev, **spec["conf_data"])
    key, args = ("conf", True), spec["conf"]
    plain, l_plain = _s21_measure(spec, key, (g2, g3), args=args)
    again, _ = _s21_measure(spec, key, (g2, g3), args=args)
    remat, l_remat = _s21_measure(spec, key, (g2, g3), remat=True,
                                  args=args)
    _check(l_plain == spec["expect"]["plain"],
           f"(a) launches per step without remat {l_plain}")
    _check(l_remat == spec["expect"]["remat"],
           f"(a) launches per step with remat {l_remat}")
    repeats = _dp_same(plain, again)
    if repeats:
        _check(_dp_same(plain, remat), "(a) the remat step is not the step "
                                       "without remat bit for bit")
        how = "bit for bit (the step repeats itself bit for bit)"
    else:
        own = _readings(again[1], plain[1], S21_SIDES)
        tol, l2_tol, leaf_tol = _bf16_limits(
            own, abs(again[0] - plain[0]) / abs(plain[0]))
        r = _readings(remat[1], plain[1], S21_SIDES)
        bad = _violations(r, tol, l2_tol, leaf_tol)
        _print_readings("(a) remat vs plain", r, l2_tol, "s21")
        _check(not bad, f"(a) remat vs plain: {bad}")
        how = "within the limits of the step's own run-to-run reading"
    t = {remat: _s21_timed(spec, key, (g2, g3), remat=remat, args=args)
         for remat in (False, True)} if dev.type == "cuda" else {}
    print(f"[s21] (a) QMugs bf16 step (batch {spec['batch']}, C = "
          f"{spec['conf_c']}, {sizes['edges_3d']} 3D edges) with remat: "
          f"loss {remat[0]:.6f}, gradients and running statistics {how}; "
          f"launches per step {l_remat} (without remat {l_plain})")
    for r, d in t.items():
        print(f"[s21] (a) remat={r}: {d['ms']:.3f} ms per step (CUDA events "
              f"over {spec['timed']} warm steps), peak max_memory_allocated "
              f"{d['peak'] / 2 ** 30:.3f} GiB; {smi}")
    return {"launches": {n: l_plain[n] + l_remat[n] for n in NONE},
            "times": t}


def _s21_noncsr(spec: dict, smi: str) -> dict:
    """(b) the flat pre-training step on the non-CSR batch against the CSR
    batch; returns (b)'s one-process results on the non-CSR batch by bf16
    (the partitions' references), the witnesses of its bf16 step
    (`S21_WITNESSES`) and the launches."""
    dev = torch.device(spec["device"])
    views = {csr: _s21_views(spec, csr) for csr in (True, False)}
    batches = {csr: _s21_batches(views[csr], dev) for csr in (True, False)}
    launches = dict(NONE)
    out = {}
    csr_f32 = None
    for bf16 in (False, True):
        ref, l_csr = _s21_measure(spec, ("flat", bf16), batches[True])
        got, l_plain = _s21_measure(spec, ("flat", bf16), batches[False])
        _check(l_csr == spec["expect"]["csr"][bf16],
               f"(b) CSR launches per step {l_csr}")
        _check(l_plain == NONE, f"(b) non-CSR launches per step {l_plain}")
        for n in NONE:
            launches[n] += l_csr[n]
        if bf16:
            # both bf16 steps against the CSR float32 step: the non-CSR
            # one within `_bf16_limits` of the CSR one's own distance
            # (the segment path rounds the pretrans BatchNorm's output to
            # bf16 before it aggregates; the kernel folds it)
            own = _readings(ref[1], csr_f32[1], S21_SIDES)
            held = _bf16_limits(own, abs(ref[0] - csr_f32[0])
                                / abs(csr_f32[0]))
            _print_readings("(b) bf16 CSR vs float32 CSR (the witness)", own,
                            held[1], "s21")
            ref = csr_f32
        else:
            csr_f32 = ref
            held = (STEP_TOL[False], {s: STEP_TOL[False]["l2"]
                                      for s in S21_SIDES})
        r, rel, bad = _dp_held(got, ref, S21_SIDES, *held)
        print(f"[s21] (b) non-CSR step bf16={bf16} vs the CSR float32 "
              f"step: loss {got[0]:.6f} vs {ref[0]:.6f}, {rel:.3g} (tol "
              f"{held[0]['loss']:.3g})")
        _print_readings(f"(b) bf16={bf16} non-CSR vs CSR float32", r,
                        held[1], "s21")
        _check(not bad, f"(b) bf16={bf16} non-CSR vs CSR: {bad}")
        out[bf16] = got
    # the bf16 step's own distance from the float32 step, the largest of
    # the seeded weights' and of weights scaled by 1 + j * 2^-16 U(-1, 1)
    # (below bf16's resolution: each rounds anew), j = 1 .. S21_WITNESSES
    own = _readings(out[True][1], out[False][1], S21_SIDES)
    own_loss = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    for j in range(1, S21_WITNESSES + 1):
        lw, w = _s21_measure(spec, ("flat", True), batches[False],
                             perturb=j * 2.0 ** -16)[0]
        own_loss = max(own_loss, abs(lw - out[False][0]) / abs(out[False][0]))
        _merge_own(own, _readings(w, out[False][1], S21_SIDES))
    _print_readings(f"(b) non-CSR bf16 witnesses ({S21_WITNESSES + 1}) vs "
                    f"the float32 step", own,
                    {s: d["l2"] for s, d in own.items()}, "s21")
    if dev.type == "cuda":
        for csr in (True, False):
            t = _s21_timed(spec, ("flat", True), batches[csr])
            print(f"[s21] (b) bf16 step on the {'CSR' if csr else 'non-CSR'}"
                  f" batch: {t['ms']:.3f} ms per step (CUDA events over "
                  f"{spec['timed']} warm steps), peak max_memory_allocated "
                  f"{t['peak'] / 2 ** 30:.3f} GiB; {smi}")
    return {"one": out, "own": (own, own_loss), "launches": launches}


def _s21_cut(views: dict, grid) -> dict:
    """This rank's part of the whole batch's non-CSR views."""
    from infomax3d_tpu_torch.parallel.edge_partition import shard_batch_edges
    from infomax3d_tpu_torch.parallel.node_partition import shard_graph_batch
    if grid.mode == "edge":
        return {k: shard_batch_edges(v, grid.k, grid.graph_index)
                for k, v in views.items()}
    return {k: shard_graph_batch(v, grid.k, grid.graph_index)
            for k, v in views.items()}


def _s21_plant(name: str):
    """Plant the partition fault `name` in this process; returns the
    undo."""
    from infomax3d_tpu_torch.models import base
    from infomax3d_tpu_torch.parallel import edge_partition, node_partition
    from infomax3d_tpu_torch.parallel.context import data_parallel_group

    def drop_ghosts(ctx, ct):
        return (ct[:ctx.n_local].clone(), None) + (None,) * len(
            ctx.saved_tensors)
    mod, attr, fake = {
        "edge aggregation not completed": (edge_partition, "all_reduce_sum",
                                           lambda x, group: x),
        "halo backward dropped": (node_partition._HaloExchange, "backward",
                                  staticmethod(drop_ghosts)),
        "BatchNorm not over the graph group": (
            base, "step_group", data_parallel_group)}[name]
    real = mod.__dict__[attr]
    setattr(mod, attr, fake)
    return lambda: setattr(mod, attr, real)


def _s21_collectives(spec: dict, batches) -> dict:
    """The collectives of one bf16 step: all-reduce and all-gather calls,
    elements and host ms (synchronized), and the halo exchange's rounds
    (sends, rows); with the step's `_measure_step` result."""
    from infomax3d_tpu_torch.parallel import collectives as C
    from infomax3d_tpu_torch.parallel import node_partition as NP
    seen = {"all_reduce": [0, 0, 0.0], "all_gather": [0, 0, 0.0],
            "halo": [0, 0, 0.0]}
    real = {"all_reduce_": C.all_reduce_, "gather_rows": C.gather_rows,
            "_p2p": NP._p2p}
    cuda = spec["device"] == "cuda"

    def timed(fn, key, rows):
        def wrapped(t, *a):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, *a)
            if cuda:
                torch.cuda.synchronize()
            s = seen[key]
            s[0] += 1
            s[1] += rows(t)
            s[2] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapped
    C.all_reduce_ = timed(real["all_reduce_"], "all_reduce",
                          lambda t: t.numel())
    C.gather_rows = timed(real["gather_rows"], "all_gather",
                          lambda t: t.numel())
    NP._p2p = timed(real["_p2p"], "halo",
                    lambda rounds: sum(r.shape[0] for r in rounds))
    try:
        got = _s21_measure(spec, ("flat", True), batches)[0]
    finally:
        C.all_reduce_, C.gather_rows, NP._p2p = (
            real["all_reduce_"], real["gather_rows"], real["_p2p"])
    return seen, got


def _s21_halo(grid, dev) -> float:
    """The halo exchange on one connected graph spanning the node shards
    (tests/test_node_partition.py's ring with random chords, at N = 4096
    with 2400 chords, float64): a message-passing layer ``tanh((h[s] +
    2 h[r]) W)`` summed at each receiver and read against a fixed
    cotangent, through `halo_exchange` / `local_segment_reduce` on this
    rank's shard, against the same layer on the whole graph; returns the
    largest error of the owned rows' gradient, of its max (a planted fault
    in the exchange's backward leaves the ghosts' share out)."""
    from infomax3d_tpu_torch.parallel.node_partition import (
        build_node_partition, halo_exchange, local_segment_reduce)
    rng = np.random.default_rng(7)
    N, D = 4096, 16
    a, b = rng.integers(0, N, 2400), rng.integers(0, N, 2400)
    keep = a != b
    ring = np.arange(N)
    snd = np.concatenate([ring, (ring + 1) % N, a[keep], b[keep]])
    rcv = np.concatenate([(ring + 1) % N, ring, b[keep], a[keep]])
    plan = build_node_partition(snd, rcv, np.ones_like(snd, bool), N, grid.k)
    h = rng.normal(size=(N, D))
    w = torch.tensor(rng.normal(size=(D, D)) / D, device=dev)
    ct = rng.normal(size=(N, D))
    g = grid.graph_index

    def t(x):
        return torch.as_tensor(x, device=dev)
    hf = t(h).requires_grad_()
    msg = torch.tanh((hf[t(snd)] + 2.0 * hf[t(rcv)]) @ w)
    full = torch.zeros(N, D, dtype=msg.dtype, device=dev).index_add_(
        0, t(rcv), msg)
    (full * t(ct)).sum().backward()
    rows = np.minimum(plan.node_idx[g], N - 1)
    owned = plan.node_mask[g]
    hl = t(h[rows] * owned[:, None]).requires_grad_()
    ext = halo_exchange(hl, [t(si[g]) for si in plan.send_idx], grid.graph)
    sl, rl = t(plan.senders_loc[g]).long(), t(plan.receivers_loc[g]).long()
    msg = torch.tanh((ext[sl] + 2.0 * hl[rl]) @ w)
    part = local_segment_reduce(msg, rl, t(plan.edge_mask[g]),
                                plan.n_local)
    (part * t(ct[rows] * owned[:, None])).sum().backward()
    ref = hf.grad[t(rows)][t(owned)]
    got = hl.grad[t(owned)]
    return float((got - ref).abs().max() / ref.abs().max())


def _s21_rank(rank: int, spec: dict, out: str):
    """One rank of (c): both modes' float32 and bf16 steps on its part of
    the batch, the planted faults, the collectives, the halo rows and the
    timings.  Writes its results to `out`/rank{rank}.pt."""
    import dataclasses as dc
    from datetime import timedelta
    from infomax3d_tpu_torch.parallel import (close_group, make_grid,
                                              make_group, using_groups)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k, res = spec["ranks"], {}
    _, dev = make_group(k, rank, f"file://{out}/store", spec["backend"],
                        spec["device"], timeout=timedelta(minutes=5))
    try:
        grid0 = make_grid(1, k, "edge")
        views = _s21_views(spec, False)
        _reset_counts()
        for mode in ("edge", "node"):
            grid = dc.replace(grid0, mode=mode)
            part = _s21_cut(views, grid)
            if mode == "node":
                res["halo"] = {key: [int(v.shape[0]) for n, v in sorted(
                    part[key].items()) if n.startswith("halo_send_")]
                    for key in part}
                res["shard"] = {key: (int(part[key]["node_mask"].sum()),
                                      int(part[key]["edge_mask"].sum()))
                                for key in part}
            batches = _s21_batches(part, dev)

            def groups():
                return using_groups(
                    data=None, edge=grid.graph if mode == "edge" else None,
                    node=grid.graph if mode == "node" else None,
                    step=grid.step)
            with groups():
                res[(mode, False)] = _s21_measure(spec, ("flat", False),
                                                  batches)[0]
                if mode == "node":
                    res["halo_err"] = _s21_halo(grid, dev)
                for name in S21_MODES[mode]:
                    undo = _s21_plant(name)
                    try:
                        res[("fault", name)] = _s21_measure(
                            spec, ("flat", False), batches)[0]
                        if name == "halo backward dropped":
                            res[("halo_err", name)] = _s21_halo(grid, dev)
                    finally:
                        undo()
                res[(mode, "collectives")], res[(mode, True)] = \
                    _s21_collectives(spec, batches)
                if spec["device"] == "cuda":
                    step, _ = _s21_fresh(spec["flat"][True], ("flat", True),
                                         dev)
                    prepared = step.prepare(*batches)
                    res[(mode, "ms")] = cuda_ms(
                        lambda: step.step(*prepared),
                        iters=spec["part_timed"], warmup=1)
        res["launches"] = _counts()
    finally:
        close_group()
    torch.save(res, f"{out}/rank{rank}.pt")


def _s21_partitions(spec: dict, b: dict, out_dir: Path, smi: str) -> dict:
    """(c) the partitioned modes over `spec["ranks"]` ranks against (b)'s
    one-process steps on the whole non-CSR batch (`b["one"]`, by bf16):
    the float32 step within STEP_TOL (the statistics within
    S21_STATS_TOL); the bf16 step against the float32 one process within
    `_bf16_limits` of the bf16 one process's witnesses (`b["own"]`), as
    `_hold_step_against_cpu(witnesses=n)` holds ill-conditioned steps
    (two bf16 steps differ by both their roundings: their distance is
    printed, not held)."""
    import shutil
    k = spec["ranks"]
    run = out_dir / "partitions"
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir(parents=True)
    torch.multiprocessing.start_processes(
        _s21_rank, args=(spec, str(run)), nprocs=k, start_method="spawn")
    ranks = [torch.load(run / f"rank{r}.pt", weights_only=False)
             for r in range(k)]
    one = b["one"]
    limits = _bf16_limits(*b["own"])
    for mode in ("edge", "node"):
        tol = dict(STEP_TOL[False], stats=S21_STATS_TOL[mode])
        l2 = {s: STEP_TOL[False]["l2"] for s in S21_SIDES}
        for bf16 in (False, True):
            got = ranks[0][(mode, bf16)]
            _check(all(_dp_same(got, r[(mode, bf16)]) for r in ranks[1:]),
                   f"(c) {mode} bf16={bf16}: the ranks differ")
            held = limits if bf16 else (tol, l2)
            r, rel, bad = _dp_held(got, one[False], S21_SIDES, *held)
            print(f"[s21] (c) {mode} partition, {k} ranks "
                  f"({spec['backend']}) bf16={bf16} vs the float32 one "
                  f"process on the whole batch: loss {got[0]:.6f} vs "
                  f"{one[False][0]:.6f}, {rel:.3g} (tol "
                  f"{held[0]['loss']:.3g}); the ranks bit-equal")
            _print_readings(f"(c) {mode} bf16={bf16} vs the float32 one "
                            f"process", r, held[1], "s21")
            _check(not bad, f"(c) {mode} bf16={bf16} vs one process: {bad}")
            if bf16:
                _print_readings(f"(c) {mode} bf16 vs the bf16 one process "
                                f"(not held)", _readings(
                                    got[1], one[True][1], S21_SIDES),
                                held[1], "s21")
        if mode == "node":
            errs = [r["halo_err"] for r in ranks]
            print(f"[s21] (c) halo exchange on a graph spanning the shards "
                  f"(N = 4096, float64): owned rows' gradient within "
                  f"{max(errs):.3g} of the whole graph's (tol "
                  f"{S21_HALO_TOL:g})")
            _check(max(errs) <= S21_HALO_TOL, f"(c) halo exchange {errs}")
        for name in S21_MODES[mode]:
            r, rel, bad = _dp_held(ranks[0][("fault", name)], one[False],
                                   S21_SIDES, tol, l2)
            if name == "halo backward dropped":
                # on the molecular batch the halo carries the one molecule
                # the cut splits; the graph spanning the shards carries
                # hundreds of rows per round
                herr = max(r_[("halo_err", name)] for r_ in ranks)
                print(f"[s21] (c) planted fault ({name}): the halo check "
                      f"{herr:.3g} (tol {S21_HALO_TOL:g}); main path: loss "
                      f"{rel:.3g}, {len(bad)} violations")
                _check(herr > S21_HALO_TOL, "the halo check passed a planted "
                                            "fault")
                continue
            print(f"[s21] (c) planted fault ({name}): loss {rel:.3g}, "
                  f"{len(bad)} violations, e.g. {bad[:2]}")
            _check(bool(bad), f"the partition check passed a planted fault "
                              f"({name})")
        seen = ranks[0][(mode, "collectives")]
        how = ("gloo, host-staged" if spec["backend"] == "gloo"
               else spec["backend"])
        print(f"[s21] (c) {mode}: collectives of one bf16 step per rank "
              f"({how}, host ms between synchronizations): " + ", ".join(
                  f"{n} {c} calls of {e} {'rows' if n == 'halo' else 'elements'}"
                  f" in all, {ms:.3f} ms" for n, (c, e, ms) in seen.items()))
        if (mode, "ms") in ranks[0]:
            where = ("time-sliced on one card; not a measure of speed"
                     if torch.cuda.device_count() < k else "one card each")
            print(f"[s21] (c) {mode}: {ranks[0][(mode, 'ms')]:.3f} ms per "
                  f"bf16 step (rank 0's CUDA events over {spec['part_timed']}"
                  f" warm steps), {k} ranks {where} ({spec['backend']}); "
                  f"{smi}")
    for key, sizes in ranks[0]["halo"].items():
        print(f"[s21] (c) node shards of {key}: halo rows per round "
              f"{sizes} (padded to 8), owned real nodes and edges per rank "
              f"{[r['shard'][key] for r in ranks]}")
    return {"launches": {n: sum(r["launches"][n] for r in ranks)
                         for n in NONE}}


def phase_slice21(smi: str, out_dir: Path, spec: dict = None) -> dict:
    """Phase 28: `remat` (a), the non-CSR batch (b) and the partitioned
    modes (c) (module docstring).  Returns the main path's launches."""
    spec = spec or _s21_spec()
    t = [time.perf_counter()]
    _reset_counts()
    a = _s21_remat(spec, smi)
    t.append(time.perf_counter())
    b = _s21_noncsr(spec, smi)
    t.append(time.perf_counter())
    c = _s21_partitions(spec, b, out_dir, smi)
    t.append(time.perf_counter())
    launches = {n: a["launches"][n] + b["launches"][n] + c["launches"][n]
                for n in NONE}
    _S21_STEPS.clear()
    print(f"[s21] main-path launches: {launches}")
    print("[s21] seconds: " + ", ".join(
        f"{name} {y - x:.1f}" for name, x, y in zip(
            ("(a) remat", "(b) non-CSR", "(c) partitions"), t, t[1:])))
    return {"launches": launches}


# --------------- phase 29: tensor parallelism, the native host collate

# phase 27's step and spec with `model_shards`: four gloo ranks on the
# one card form the (data, model) grid of 2 x 2 (rank d * 2 + m); the first
# `TP_ALONE` of them also run `model_shards: TP_ALONE` alone on the whole
# batch over a model group of their own, and then the CLI.  Phase 27's
# one-process references and its two data-parallel ranks (`_DP_CACHE`)
# are the yardsticks.
TP_RANKS = 4
TP_ALONE = 2
TP_STEPS = 3
TP_CLI = dict(DP_CLI, n_shards=1, model_shards=TP_ALONE)
TP_FAULTS = ("backward summed over the model ranks",
             "shards gathered in reversed rank order",
             "gradient mean over the model ranks")
# what phase 27 leaves for phase 29: its one-process references and the
# ranks' results
_DP_CACHE = {}


def _tp_fresh(spec: dict, kind: str, bf16: bool, dev, grid, cache: dict):
    """The seeded step of `kind` ("pre", "gin") sharded for this rank's
    part of `grid`'s model group, at its initial shards and running
    statistics, its optimizer without state and its own loss; built once
    per process and model group size."""
    from infomax3d_tpu_torch.parallel import tp
    key = (kind, bf16, grid.k)
    if key not in cache:
        if kind == "pre":
            step = build_step(spec["pre"][bf16], dev)
            models = {"model": step.model, "model3d": step.model3d}
        else:
            step = build_supervised_step(spec["gin"][bf16], dev)
            models = {"model": step.model}
        whole = sum(p.numel() for m in models.values()
                    for p in m.parameters())
        tp.shard_step(step, grid.k, grid.graph_index)
        state = {n: {k: v.clone() for k, v in m.state_dict().items()}
                 for n, m in models.items()}
        cache[key] = (step, models, state, getattr(step, "loss_fn", None),
                      whole)
    step, models, state, loss, _ = cache[key]
    for n, m in models.items():
        m.load_state_dict(state[n])
    step.optimizer.state.clear()
    if loss is not None:
        step.loss_fn = loss
    return step, models


def _tp_measure(step, models: dict, batches, grid, data=None) -> tuple:
    """`_measure_step` under the model group (and `data`), the sharded
    leaves' gradients gathered whole over the model ranks."""
    from infomax3d_tpu_torch.parallel import tp, using_groups
    from infomax3d_tpu_torch.parallel.collectives import gather_leaves
    with using_groups(data=data, model=grid.model):
        loss, out = _measure_step(step, models, batches)
    for pre, m in models.items():
        sh = tp.sharded_leaves(m)
        names = list(sh)
        whole = gather_leaves([m.get_parameter(n).grad for n in names],
                              [sh[n].dim for n in names], grid.model)
        out.update({f"{pre}.{n}": w.float().cpu()
                    for n, w in zip(names, whole)})
    return loss, out


def _tp_digest(models: dict, grid) -> str:
    """A digest of the models' whole parameters (gathered) and running
    statistics, for the model ranks' bit-equality."""
    import hashlib
    from infomax3d_tpu_torch.parallel import tp
    h = hashlib.sha256()
    for m in models.values():
        for n, t in sorted(tp.full_state_dict(m, grid.model).items()):
            h.update(n.encode())
            h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _tp_plant(name: str, grid):
    """Plant the tensor-parallel fault `name`; returns the undo."""
    from infomax3d_tpu_torch.parallel import collectives as C
    from infomax3d_tpu_torch.train import supervised as S
    if name == TP_FAULTS[0]:
        def summed(ctx, *cts):
            return (None, None) + tuple(
                C.all_reduce_(ct.contiguous().clone(), ctx.group).chunk(
                    ctx.k, d)[ctx.index].contiguous()
                for ct, d in zip(cts, ctx.dims))
        obj, attr, fake = C._GatherShards, "backward", staticmethod(summed)
    elif name == TP_FAULTS[1]:
        real_gather = C._gather_flat
        obj, attr = C, "_gather_flat"

        def fake(flat, group):
            return real_gather(flat, group).flip(0)
    else:
        obj, attr, fake = S, "step_group", lambda: grid.model
    real = obj.__dict__[attr]
    setattr(obj, attr, fake)
    return lambda: setattr(obj, attr, real)


def _tp_gathers(step, batches, grid, cuda: bool) -> list:
    """[calls, elements, host ms] of the shard gathers of one step (a
    synchronization before and after each)."""
    from infomax3d_tpu_torch.parallel import collectives as C
    from infomax3d_tpu_torch.parallel import using_groups
    seen = [0, 0, 0.0]
    real = C._gather_flat

    def timed(flat, group):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(flat, group)
        if cuda:
            torch.cuda.synchronize()
        seen[0] += 1
        seen[1] += out.numel()
        seen[2] += (time.perf_counter() - t0) * 1e3
        return out
    C._gather_flat = timed
    try:
        with using_groups(model=grid.model):
            step.loss_and_grads(*batches)
    finally:
        C._gather_flat = real
    return seen


def _tp_rank(rank: int, spec: dict, out: str, port: int):
    """One rank of phase 29: `model_shards: spec["alone"]` alone (the
    first that many ranks, the whole batch; the planted faults, three
    steps' bit-equality, the bytes, gathers and ms), the grid of 2 data
    shards (every rank, its data shard); then the CLI with that
    `model_shards` (the same ranks, torchrun's environment).  Writes its
    results to `out`/rank{rank}.pt."""
    import torch.distributed as dist
    from datetime import timedelta
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import train as cli_train
    from infomax3d_tpu_torch.parallel import (CrossDeviceLoss, Grid,
                                              close_group, make_group,
                                              make_tp_grid, tp, using_groups)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, cache = {}, {}
    group, dev = make_group(spec["ranks"], rank, f"file://{out}/store",
                            spec["backend"], spec["device"],
                            timeout=timedelta(minutes=5))
    cuda = spec["device"] == "cuda"
    ka = spec["alone"]
    try:
        grid = make_tp_grid(2, spec["ranks"] // 2)
        d = grid.data_index
        own = dist.new_group(list(range(ka)))
        if rank < ka:
            alone = Grid(1, ka, "model", 0, rank, None, own, own)
            whole = _dp_batches(spec, 0, 1, dev)
            _reset_counts()
            for kind, bf16 in (("pre", False), ("pre", True),
                               ("gin", False)):
                step, models = _tp_fresh(spec, kind, bf16, dev, alone, cache)
                before = _counts()
                res[("alone", kind, bf16)] = _tp_measure(
                    step, models, step.prepare(*whole[kind])
                    if kind == "pre" else (step.prepare(*whole[kind]),),
                    alone)
                res[("alone", kind, bf16, "launches")] = {
                    n: c - before[n] for n, c in _counts().items()}
            res["launches"] = _counts()
            for name in TP_FAULTS:
                step, models = _tp_fresh(spec, "pre", False, dev, alone, cache)
                undo = _tp_plant(name, alone)
                try:
                    res[("fault", name)] = _tp_measure(
                        step, models, step.prepare(*whole["pre"]), alone)
                finally:
                    undo()
            step, models = _tp_fresh(spec, "pre", False, dev, alone, cache)
            batches = step.prepare(*whole["pre"])
            with using_groups(model=alone.model):
                res["losses"] = [float(step.step(*batches))
                                 for _ in range(spec["steps"])]
            res["digest"] = _tp_digest(models, alone)
            params = [p for g in step.optimizer.param_groups
                      for p in g["params"]]
            res["bytes"] = tp.master_bytes(params, step.optimizer)
            res["whole_elements"] = cache[("pre", False, ka)][4]
            step, models = _tp_fresh(spec, "pre", True, dev, alone, cache)
            batches = step.prepare(*whole["pre"])
            res["gathers"] = _tp_gathers(step, batches, alone, cuda)
            if cuda:
                with using_groups(model=alone.model):
                    res["ms"] = cuda_ms(lambda: step.step(*batches),
                                        iters=spec["timed"], warmup=1)
        shard = _dp_batches(spec, d, 2, dev)
        before = _counts()
        for bf16 in (False, True):
            step, models = _tp_fresh(spec, "pre", bf16, dev, grid, cache)
            step.loss_fn = CrossDeviceLoss(step.loss_fn, grid.data)
            res[("grid", bf16)] = _tp_measure(
                step, models, step.prepare(*shard["pre"]), grid, grid.data)
        res["grid_launches"] = {n: c - before[n] for n, c in _counts().items()}
    finally:
        close_group()
    if rank < ka:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          RANK=str(rank), WORLD_SIZE=str(ka),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(ka))
        config, overrides = spec["cli"]
        args = load_config(config, dict(overrides, logdir=f"{out}/cli"))
        _reset_counts()
        t0 = time.perf_counter()
        res["cli"] = cli_train(args, device=spec["device"])
        res["cli_s"] = time.perf_counter() - t0
        res["cli_launches"] = _counts()
    torch.save(res, f"{out}/rank{rank}.pt")


def _tp_spec() -> dict:
    return dict(_dp_spec(), ranks=TP_RANKS, alone=TP_ALONE, steps=TP_STEPS,
                cli=(TRAINER_PRE, TP_CLI))


def _native_collate(smi: str) -> dict:
    """The native collate against numpy on phase 18's QMugs batch (500
    molecules x 3 conformers of 20 to 70 atoms through
    `conformer_collate`): every array equal, host ms per collate of each
    (the best of a few)."""
    from infomax3d_tpu_torch.data.loader import conformer_collate
    c = CONF_CONFS[CONF_QMUGS]
    ds = SyntheticMolecules(BATCH, num_conformers=c, **CONF_DATA)
    items = [{"graph2d": ds.graph2d(i),
              "conformers3d": [ds.graph3d(i, conformer=j) for j in range(c)]}
             for i in range(BATCH)]
    bucket = bucket_for([it["graph2d"] for it in items], BATCH)
    ms = {}
    views = {}
    for path, env in (("native", None), ("numpy", "1")):
        if env:
            os.environ["INFOMAX3D_NO_NATIVE"] = env
        try:
            best = None
            for _ in range(2):
                t0 = time.perf_counter()
                views[path] = conformer_collate(items, bucket)
                s = (time.perf_counter() - t0) * 1e3
                best = s if best is None else min(best, s)
            ms[path] = best
        finally:
            os.environ.pop("INFOMAX3D_NO_NATIVE", None)
    bad = [f"{v}.{k}" for v in views["numpy"] for k in views["numpy"][v]
           if not (views["native"][v][k].dtype == views["numpy"][v][k].dtype
                   and np.array_equal(views["native"][v][k],
                                      views["numpy"][v][k]))]
    _check(not bad and views["native"].keys() == views["numpy"].keys(),
           f"native collate differs from numpy: {bad}")
    edges = int(views["native"]["graph3d"]["csr_row_ptr"][-1])
    print(f"[tp] native collate of the QMugs batch ({BATCH} molecules x "
          f"{c} conformers, {edges} 3D edges): every array of "
          f"{sum(len(v) for v in views['numpy'].values())} equal to "
          f"numpy's; host ms per collate {ms['native']:.3f} native against "
          f"{ms['numpy']:.3f} numpy (best of 2; {smi})")
    return ms


def phase_slice22(smi: str, out_dir: Path, loader: dict = None,
                  spec: dict = None) -> dict:
    """Phase 29: tensor parallelism (`model_shards`) and the native host
    collate.  Four gloo ranks on the card: (a) `model_shards: 2` alone
    (ranks 0, 1) on phase 27's whole batch, the float32 pre-training and
    GIN steps within STEP_TOL of phase 27's one process, the bf16
    pre-training step within its `_bf16_limits`, launches per rank those
    of one process; the model ranks bit-equal after three steps; the
    bytes of masters and Adam moments per rank; the shard gathers of a
    step with their host ms; ms per bf16 step; three planted faults that
    must fail; (b) `n_shards: 2` x `model_shards: 2`, the pre-training
    step against phase 27's data-parallel ranks (float32 STEP_TOL, bf16
    its limits); (c) the CLI with `model_shards: 2` (ranks 0, 1): one run
    directory, whose checkpoint holds the one-process layout and loads
    strictly into the one-process models.  Meanwhile, on the host, the
    native collate against numpy; with `loader` (phase 19's QMugs loader
    waits), those too.  Without phase 27 before it, the yardsticks are
    one process's steps, computed here.  Returns the main path's
    launches."""
    import shutil
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import (build_models, resolve_collate,
                                               resolve_fast_paths)
    from infomax3d_tpu_torch.train.checkpoint import load_checkpoint
    spec = spec or _tp_spec()
    t = [time.perf_counter()]
    if "refs" not in _DP_CACHE:
        # phase 29 alone: the one-process references of its own
        whole = _dp_batches(spec, 0, 1, torch.device(spec["device"]))
        _DP_CACHE.update(refs={kind: _dp_limits(spec, kind, whole)
                               for kind in ("pre", "gin")}, ranks=[])
    refs, dp_ranks = _DP_CACHE["refs"], _DP_CACHE["ranks"]
    ka = spec["alone"]
    # the grid's yardstick: phase 27's ranks where they were two data
    # shards, else its one process on the whole batch
    dp_ref = len(dp_ranks) == 2
    run = out_dir / "tensor_parallel"
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir(parents=True)
    ctx = torch.multiprocessing.start_processes(
        _tp_rank, args=(spec, str(run), _free_port()), nprocs=spec["ranks"],
        start_method="spawn", join=False)
    collate_ms = _native_collate(smi)
    while not ctx.join():
        pass
    ranks = [torch.load(run / f"rank{r}.pt", weights_only=False)
             for r in range(spec["ranks"])]
    t.append(time.perf_counter())
    for kind, bf16 in (("pre", False), ("pre", True), ("gin", False)):
        f32, b16, limits = refs[kind]
        got = ranks[0][("alone", kind, bf16)]
        _check(all(_dp_same(got, r[("alone", kind, bf16)])
                   for r in ranks[1:ka]),
               f"(a) {kind} bf16={bf16}: the model ranks differ")
        for r in ranks[:ka]:
            per = r[("alone", kind, bf16, "launches")]
            _check(per == spec["expect"][(kind, bf16)],
                   f"(a) {kind} bf16={bf16}: launches per rank {per}")
        held = limits if bf16 else (STEP_TOL[False], {
            s: STEP_TOL[False]["l2"] for s in DP_SIDES[kind]})
        r, rel, bad = _dp_held(got, b16 if bf16 else f32, DP_SIDES[kind],
                               *held)
        print(f"[tp] (a) {kind} bf16={bf16}: model_shards {ka} "
              f"({spec['backend']}) vs one process: loss {got[0]:.6f} vs "
              f"{(b16 if bf16 else f32)[0]:.6f}, {rel:.3g} (tol "
              f"{held[0]['loss']:.3g}); the model ranks bit-equal")
        _print_readings(f"(a) {kind} bf16={bf16} model_shards {ka} vs one "
                        f"process", r, held[1], "tp")
        _check(not bad, f"(a) {kind} bf16={bf16} vs one process: {bad}")
    _check(all(r["digest"] == ranks[0]["digest"]
               and r["losses"] == ranks[0]["losses"] for r in ranks[1:ka]),
           "(a) the model ranks differ after three steps")
    print(f"[tp] (a) {spec['steps']} float32 steps: losses "
          f"{ranks[0]['losses']}, the model ranks' losses and gathered "
          f"parameters and statistics bit-equal")
    for name in TP_FAULTS:
        r, rel, bad = _dp_held(ranks[0][("fault", name)], refs["pre"][0],
                               DP_SIDES["pre"], STEP_TOL[False],
                               {s: STEP_TOL[False]["l2"]
                                for s in DP_SIDES["pre"]})
        print(f"[tp] (d) planted fault ({name}), float32: loss {rel:.3g}, "
              f"{len(bad)} violations, e.g. {bad[:2]}")
        _check(bool(bad), f"the tensor-parallel check passed a planted "
                          f"fault ({name})")
    whole_b = 12 * ranks[0]["whole_elements"]
    for i, r in enumerate(ranks[:ka]):
        print(f"[tp] (a) rank {i}: {r['bytes']} bytes of float32 masters "
              f"and Adam moments ({r['bytes'] / whole_b:.4f} of one "
              f"process's {ranks[0]['whole_elements']} elements x 12 B = "
              f"{whole_b} B)")
    _check(ranks[0]["bytes"] < (1 / ka + 0.05) * whole_b,
           f"(a) a rank holds {ranks[0]['bytes']} of {whole_b} bytes")
    calls, elems, gms = ranks[0]["gathers"]
    how = "gloo, host-staged" if spec["backend"] == "gloo" else "nccl"
    print(f"[tp] (a) shard gathers of one bf16 pre-training step per rank: "
          f"{calls} all-gathers of {elems} elements in all ({how}, "
          f"synchronized), {gms:.3f} ms host")
    if "ms" in ranks[0]:
        where = ("time-sliced on one card" if torch.cuda.device_count()
                 < ka else "one card each")
        print(f"[tp] (a) model_shards {ka}, {ka} ranks {where} "
              f"({spec['backend']}): {ranks[0]['ms']:.3f} ms per bf16 "
              f"pre-training step (rank 0's CUDA events over "
              f"{spec['timed']} warm steps); not a measure of speed; {smi}")
    for bf16 in (False, True):
        f32, b16, limits = refs["pre"]
        km = spec["ranks"] // 2
        for r in range(spec["ranks"]):
            got = ranks[r][("grid", bf16)]
            ref = dp_ranks[r // km][("pre", bf16)] if dp_ref else \
                (b16 if bf16 else f32)
            _check(_dp_same(got, ranks[r - r % km][("grid", bf16)]),
                   f"(b) bf16={bf16}: the model ranks of data shard "
                   f"{r // km} differ")
            held = limits if bf16 else (STEP_TOL[False], {
                s: STEP_TOL[False]["l2"] for s in DP_SIDES["pre"]})
            rd, rel, bad = _dp_held(got, ref, DP_SIDES["pre"], *held)
            if r % km == 0:
                what = (f"phase 27's data-parallel rank {r // km}" if dp_ref
                        else "one process on the whole batch")
                print(f"[tp] (b) bf16={bf16} rank {r}: 2 x {km} grid vs "
                      f"{what}: loss {got[0]:.6f} vs {ref[0]:.6f}, {rel:.3g}")
                _print_readings(f"(b) bf16={bf16} grid vs data parallel",
                                rd, held[1], "tp")
            _check(not bad, f"(b) bf16={bf16} rank {r} vs data parallel: "
                            f"{bad}")
    for r in ranks:
        _check(r["grid_launches"] == {
            n: spec["expect"][("pre", False)][n]
            + spec["expect"][("pre", True)][n] for n in NONE},
            f"(b) launches per rank {r['grid_launches']}")
    results = [r["cli"] for r in ranks[:ka]]
    _check(all(res == results[0] for res in results[1:]),
           "(c) the ranks' CLI results differ")
    _check(all(np.isfinite(v) for v in results[0].values()),
           f"(c) non-finite metrics {results[0]}")
    cli_dir = _run_dir(run / "cli")
    for name in ("best_checkpoint.pt", "last_checkpoint.pt",
                 "train_arguments.yaml", "metrics.jsonl", "timing.json"):
        _check((cli_dir / name).exists(), f"(c) no {name}")
    for r in ranks[:ka]:
        _check(r["cli_launches"] == spec["expect"]["cli"],
               f"(c) launches per rank {r['cli_launches']}")
    args = load_config(spec["cli"][0], dict(spec["cli"][1]))
    resolve_collate(args)
    resolve_fast_paths(args)
    one = build_models(args)
    payload = load_checkpoint(str(cli_dir / "best_checkpoint.pt"))
    for key, mod in one.items():
        mod.load_state_dict(payload[f"{key}_state_dict"], strict=True)
        for n, p in mod.named_parameters():
            _check(torch.equal(p.detach(), payload[f"{key}_state_dict"][n]),
                   f"(c) {key}.{n} differs after the load")
    moments = payload["optimizer_state_dict"]["state"].values()
    _check(sorted(tuple(v["exp_avg"].shape) for v in moments) == sorted(
        tuple(p.shape) for mod in one.values() for p in mod.parameters()),
        "(c) the checkpoint's Adam moments are not whole")
    loss_key = next(key for key in results[0] if "NTXent" in key)
    print(f"[tp] (c) CLI {spec['cli'][0]} with model_shards {ka} "
          f"(torchrun's environment, {spec['cli'][1]['dist_backend']}): "
          f"{ranks[0]['cli_s']:.1f} s, {loss_key} "
          f"{results[0][loss_key]:.6f}, the ranks' results equal; its best "
          f"checkpoint ({len(payload['model_state_dict'])} + "
          f"{len(payload['model3d_state_dict'])} tensors, whole) loads "
          f"strictly into the one-process models, Adam's moments whole")
    if loader:
        cache, syn = loader
        print(f"[tp] QMugs loader host s per train step with the native "
              f"collate (phase 19 of this run): cache {cache:.6f}, synthetic "
              f"{syn:.6f}; native collate {collate_ms['native']:.3f} ms "
              f"against numpy {collate_ms['numpy']:.3f} ms a batch")
    launches = dict(NONE)
    for r in ranks:
        for n in NONE:
            launches[n] += r.get("launches", NONE)[n] + \
                r["grid_launches"][n] + r.get("cli_launches", NONE)[n]
    t.append(time.perf_counter())
    print(f"[tp] tensor-parallel main-path launches: {launches}")
    print("[tp] seconds: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(
            ("the ranks and the native collate", "checks"), t, t[1:])))
    return {"launches": launches}


class _Phase:
    """Prints a phase's seconds when it ends (and lets its error pass)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        print(f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f} s")
        return False


def main() -> int:
    with _Phase("1 device"):
        smi = phase_device()
    with _Phase("2 build"):
        phase_build()
    g = bench_batch()
    with _Phase("3 kernels"):
        errs = phase_kernels(g)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    with _Phase("4 serving"):
        serve_launches = phase_slice(out_dir)
        fwd_ms = phase_forward_time(g)
    with _Phase("5 profile"):
        phase_profile(g, fwd_ms)
    with _Phase("7 training kernels"):
        _merge_errs(errs, phase_train_kernels(g))
    with _Phase("8 training"):
        train = phase_train(smi)
    gg, _ = gin_batch()
    with _Phase("11 GIN kernels"):
        _merge_errs(errs, phase_gin_kernels(gg))
    with _Phase("12 GIN training"):
        gin = phase_gin_train(smi)
    ob, _ = ot_slice_batch()
    with _Phase("14 OT kernel"):
        _merge_errs(errs, phase_ot_kernels(ob, g))
    with _Phase("15 OT training"):
        ot_run = phase_ot_train(smi)
    with _Phase("17 trainer CLI"):
        trainer = phase_trainer(smi, out_dir)
    with _Phase("18 multi-conformer pre-training"):
        conf = phase_conformers(smi, out_dir)
        _merge_errs(errs, conf["errs"])
    with _Phase("19 data layer"):
        data = phase_data(smi, out_dir, {
            "pre_f32": (trainer["runs"]["pre_f32"], TRAINER_STEPS["pre_f32"]),
            "pre": (trainer["runs"]["pre"], TRAINER_STEPS["pre"]),
            "qmugs": (conf["cli"], CONF_CLI_STEPS)})
    with _Phase("20 serving CLI"):
        serving = phase_serving(smi, out_dir,
                                conf["cli"]["dir"] / "best_checkpoint.pt",
                                data["gin_ckpt"], data["caches"])
    with _Phase("21 pre-training baselines"):
        base = phase_baselines(smi, out_dir, data["caches"])
        _merge_errs(errs, base["errs"])
    with _Phase("22 OT family trainer"):
        family = phase_ot_family(smi, out_dir)
        _merge_errs(errs, family["errs"])
    with _Phase("23 GIN options and transformers"):
        s16 = phase_slice16(smi, out_dir)
        _merge_errs(errs, s16["errs"])
    with _Phase("24 PNAOriginal and SMP"):
        s17 = phase_slice17(smi, out_dir)
        _merge_errs(errs, s17["errs"])
    with _Phase("25 BYOL, EGNN and SAN"):
        s18 = phase_slice18(smi, out_dir)
        _merge_errs(errs, s18["errs"])
    with _Phase("26 the last trainers and model names"):
        s19 = phase_slice19(smi, out_dir)
        _merge_errs(errs, s19["errs"])
    with _Phase("27 data parallel"):
        dp = phase_data_parallel(smi, out_dir)
    with _Phase("28 remat, the non-CSR batch, the partitions"):
        s21 = phase_slice21(smi, out_dir)
    with _Phase("29 tensor parallelism, the native collate"):
        s22 = phase_slice22(smi, out_dir, data["loader"]["qmugs"])
    # every kernel's launches over the seventeen main paths (serving,
    # pre-training, GIN training, OT training, the trainer CLI,
    # multi-conformer pre-training, the data layer, the serving CLI, the
    # baselines' CLI runs, the OT family's CLI runs, the supervised CLI
    # runs of the GIN's options and the transformers, those of
    # PNAOriginal and SMP, those of BYOL, EGNN and SAN, those of the
    # philosophy trainer and the GeoMol fine-tune, the data-parallel
    # steps and CLI run, phase 28's remat and CSR steps, and phase 29's
    # tensor-parallel steps and CLI run)
    launches = {n: serve_launches[n] + train["launches"][n]
                + gin["launches"][n] + ot_run["launches"][n]
                + trainer["launches"][n] + conf["launches"][n]
                + data["launches"][n] + serving["launches"][n]
                + base["launches"][n] + family["launches"][n]
                + s16["launches"][n] + s17["launches"][n]
                + s18["launches"][n] + s19["launches"][n]
                + dp["launches"][n] + s21["launches"][n]
                + s22["launches"][n]
                for n in serve_launches}
    with _Phase("6 kernel times"):
        rows = phase_kernel_times(g, launches, errs)
    with _Phase("9 training profile"):
        in_step = phase_train_profile(train)
    with _Phase("10 training kernel times"):
        rows += phase_train_kernel_times(g, launches, errs, in_step)
    with _Phase("13 GIN profile and kernel times"):
        gin_in_step = phase_gin_profile(gin)
        rows += phase_gin_kernel_times(gg, launches, errs, gin_in_step)
    with _Phase("16 OT profile and kernel times"):
        ot_in_step = phase_ot_profile(ot_run)
        rows += phase_ot_kernel_times(ob, launches, errs, ot_in_step)
        phase_launch_floor(ob, launches, ot_in_step)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
