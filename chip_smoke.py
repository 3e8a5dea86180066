"""Smoke run of the PyTorch/CUDA port (skrx_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without CUDA it exits 2
before doing anything; run alone, outside a checkout, the import of
skrx_torch fails and it exits 1). The run's depth (steps, test users,
repetitions: REPS and the constants beside it) is cut so that the whole
script takes about half of its 1,200 s limit; FULL_DEPTH holds the values
before that cut, at which experiments/chip_phaseNN.py runs phase NN alone
(9 and 12-18). Where a phase below says "one epoch" or "every test user",
phases 8 and 10-14 run EPOCH_STEPS, SEQ_STEPS, WALK_WINDOW, TOWER_STEPS or
MM_STEPS steps and evaluate their models on EVAL_USERS test users (the
main path's models of phases 3-7 and Pop and CML keep every step and
user).

1. Environment: the card's name and power limit (nvidia-smi), the torch
   version, TF32 off for f32 matmuls, and the nvcc build of the kernels
   (every ``csrc/*.cu``, one nvcc each, all started together).
2. Every kernel against its plain PyTorch version on a CPU copy of the same
   inputs. Serving kernels at the serving shape (B=1024 users, the
   40,981-item catalog, k=10, the seen-table width of the generated data);
   the rank kernels at the evaluation shapes (B=64 and 1024, k=50, the
   evaluator's real test-table width T); and adversarial inputs: tie
   storms, fully masked rows, -inf rows, duplicate candidates, signed
   zeros; probes that are masked, out of range, duplicated or scored -inf,
   T=1 and T>128, rows with fewer than k unmasked items; direct_rank also
   on a row with NaN at every 7th id (probes on and beside them) and a row
   of +0.0 and -0.0 at alternate ids; kth_largest at
   W in {128, 256, 1,408, 4,096, 5,000} and k in {1, 10, 50, W} on ties
   across the k-th place, all -inf rows, signed zeros and subnormals,
   negatives only, fewer than k finite entries (its bits equal the plain
   version's); extract at k = 10 and 50 on blocks of 0, 1, 31, 32, 33, k-1,
   k, k+1, F and F+1 survivors (F = 256, the most it ranks directly), a
   block whose every column equals tau and +-0.0 ties (values as int32);
   pruned_merge at k = 10 and 50 on rows of the same survivor counts (its
   own F = 256) in a row of 549 lanes, repeated (value, id) pairs with
   +-0.0 of one id below and above F, value ties across ids, NaN
   candidates, and vmem_topk on the chunked evaluation's merge (a chunk of
   8,192 and the last chunk's 21 items beside the running best), values as
   int32; rank_count on +-0.0 ties between probe and candidate, NaN
   candidates and probes, -inf candidates with the sentinel id against
   -inf probes, negative ids, probes equal to a candidate pair, runs of
   repeated keys, W in {37, 2,349} and T in {1, 129, 416}; submax at
   block_n in {4,096, 256, 128}, N in {40,981, 1,000}, with and without a
   mask, on groups of +0.0 before -0.0, -0.0 before +0.0, -0.0 only, NaN
   of either sign, +inf beside NaN and a fully masked row (its max as
   jnp.maximum folds: NaN when the group holds one, -0.0 below +0.0; values
   as int32). Selection and counting do no arithmetic, so values, ids and
   ranks must be equal (NaN equal to NaN by isnan, not by payload). The
   train path's ordered sums (skrx_torch/ops/scatter.py): ordered_row_sum
   at GRU4RecPlus's 2,176 gathered rows (index_put_), SASRec's 6,400 and
   SRGNN's 51,200 (sorted pieces), d=64 and 1-D, ids of the data's
   popularity, and segsum (#11) on a fixed gather set
   (the training pairs' items into the catalog's rows, D=1 and 64, by
   fixed_sum and by fixed_gather's gradient), each against its plain
   version within 1e-5 * sum|g| a row and twice (three launches) with the
   same bits.
3. Serving: Gowalla-scale synthetic data (29,858 users, 40,981 items,
   1,027,370 interactions), BPRMF at its defaults (n_dim=64, random weights
   from a seed) built by name on cuda, TopKRecommender.recommend for
   batches of 1, 16, 64, 256 and 1024 users. The launch counts are reset
   just before and read just after; every serving kernel must have
   launched. Each answer must equal the plain top-k of the same scores on
   the CPU and hold no seen item. The host time of a call
   (experiments/host_call_times.py): blockwise_topk at B=1 and 64,
   recommend p50 at B=1, the loaded exported tail at B=64. The rank tail
   exported (TopKRecommender.export_program at B=64): its bytes, seconds
   and the skrx operators of its graph (submax, kth_largest, extract and
   pruned_merge required); loaded back with torch.export.load and run on
   64 users' predict scores and seen rows, each of the four launched
   (counts set to 0 just before, read just after; part of the main path's
   counts), ids and values bit-equal to recommend's and to the plain top-k
   on the CPU; the same bytes loaded and run in a fresh process that
   imports torch and skrx_torch only (no jax), bit-equal again, each
   kernel launched there (the process runs beside phases 4-6 and is
   checked at their end).
4. Training at Gowalla scale: the same model, fit() for 2 epochs with
   evaluation after each (metrics Precision/Recall/MAP/NDCG at 10..50,
   test batch 64). Both epochs on the captured route (the epoch as one
   program: a CUDA graph of one whole step on the flat parameter vector,
   replayed once a batch); each epoch's route, replays, warm-up steps and
   capture seconds printed, one replay for each step. Both losses finite
   and falling, rank_count launched during fit(), NDCG@10 above the
   untrained model's, and for 1,024 test users the card's per-user
   metrics equal the plain route's on CPU copies of the same scores and
   tables within 1e-6. Then one epoch on the captured route and one on the
   eager route (run_epoch(captured=False)) from the same weights, Adam
   state and seed: the loss, every parameter, Adam's moments and step
   count equal bit for bit (the card sums in one fixed order), the
   captured one replaying fit()'s graph; the seconds of each route's
   whole epoch and its busy share (torch.profiler over one whole epoch),
   with the card's name and power limit (epoch_routes).
5. Small catalog: synthetic data at MovieLens-1M scale (6,040 users, 3,706
   items, 1,000,209 interactions), fit() for one epoch and its
   evaluate(); direct_rank must have launched, and equals its plain
   version at that shape.
6. LightGCN at Gowalla scale, at its defaults (embed_size 64, 3 layers,
   adj_type "pre", batch 1,024, Adam) on the phase-3 data. The graph
   kernel (segsum, whose last warp to finish a row of several segments
   merges it) against segsum_plain in float64 on CPU copies, per row
   within 1e-5 * sum|msg|, forward (A) and backward (A^T), f32 and bf16
   messages, with and without an edge mask, at the real graph (70,839 rows,
   1,464,964 edges, D=64; its largest in-degree printed) and on adversarial
   graphs: a hub of >= 20 segments, 40 rows of 2-4 segments side by side
   (many merged rows in one block), isolated rows and the empty graph
   (exact zeros), masked edges from inf/NaN rows (finite output), a
   rectangular operator, D=8 and D=128; every arrival counter 0 after each
   launch, and three launches in a row on one graph equal bit for bit. The
   gradient of one batch's loss on the card against the same loss through
   segsum_plain on CPU copies. fit() for 2 epochs with evaluation after
   each, both on the captured route (segsum forward and backward inside
   the graph; route, replays and capture seconds printed): losses finite
   and falling, NDCG@10 above the untrained model's, segsum launched
   exactly 2 x steps x 6 + 3 per evaluate() + 6 per warm-up step of the
   capture (a replay adds the launches its capture recorded; the warm-up
   steps before the capture launch as any step). Serving: recommend for
   1, 64 and 1,024 users equals the plain top-k of the same scores and
   holds no seen item. Then phase 4's two routes from one state, equal
   bit for bit, with their times and busy shares; the captured epoch's
   profile must hold device time and segsum among its kernels (the
   profiler records a replay's kernels).
7. Fused score-and-select and chunked evaluation. The fused kernels
   (dot_submax, dot_extract) and rank_lookup_count against their plain
   versions on CPU copies, bit for bit (values, ids, tau, ranks, found): at
   the serving shape (B=1024, the Gowalla catalog, d=64, k=10, the seen
   table), at the evaluation shapes (B=64 and 1024, k=50, the evaluator's
   real T and L; B=1 and 7 at the serving shape), and on adversarial
   inputs: duplicated item rows and zero user vectors over a constant bias
   (ties across whole column blocks, more survivors than the list holds),
   item columns repeated every 512 columns (ties across the slices a
   cluster of CTAs splits a block into), fully masked rows and rows with
   fewer than k unmasked items, N not a multiple of the block, d in {8,
   60, 128, 512}, no bias, probes masked, out of range, padding,
   duplicated, one or more than 128 a row; dot_submax alone at B=1, 7 and
   33 (each block split over 8 CTAs) with mask ids in every CTA's slice,
   repeated columns, a zero user vector over a +-0.0 bias and a NaN bias
   on a few items, d in {8, 60, 64, 128, 512} (the int32 views equal, NaN
   by isnan); rank_lookup_count on rows whose ids repeat with NaN, -inf
   and finite copies, rows of extract's empty slots, a row with no -inf
   lane, probes equal to the sentinel, W in {37, 550, 2,049, 5,000} (up to
   three tiles) and T in {1, 129, 416}.
   TopKRecommender(fused="always") for BPRMF and LightGCN at 1, 64 and
   1,024 users: equal to dot_topk's plain version on CPU copies, no seen
   item, within 1e-5 of the score-matrix route (ids equal where its values
   are separated), and less memory during the call than one (B, N) f32
   score matrix. evaluate() with eval_mode "fused" (BPRMF after phase 4's
   fit(), LightGCN after phase 6's) and "chunked" (BPRMF, 8,192 items a
   chunk): the kernels of each route launched, metrics within 1e-4 of the
   full route's. A catalog of 1,048,576 items (d=64, B=256, random factors
   and seen table from the seed): dot_topk equal to its plain version, and
   the peak memory of both routes.
8. The rest of fit() and three more models, on the phase-3 data.
   BPRMF with optimizer="lazy_adam" (BPRMFConfig defaults otherwise):
   fit() for 2 epochs with a checkpoint after each (under build/): losses
   finite and falling, submax, kth_largest, extract and rank_count
   launched, no table gradient formed. Epoch 0 run alone from fit()'s
   starting state equals fit()'s checkpoint of epoch 0 bit for bit (two
   runs from one seed). One lazy step on the card against the same step
   on CPU copies of the batch and state: touched rows of the three
   tables, their moments within 1e-5 of each tensor's largest magnitude,
   counts equal; untouched rows, moments and counts bit-unchanged. A new
   model with resume=True and epochs=3 starts at epoch 2 with parameters,
   moments, counts and early stopping bit-equal to checkpoint 1, and its
   loss is finite. The same model with profile_dir writes a trace of its
   second epoch (both epochs cut to their first TRAIN_WINDOW steps) that
   names the port's kernels. evaluate_group(): four
   groups whose metrics, weighted by their test users, equal evaluate()'s
   within 1e-6. Pop: fit() (nothing trained, one evaluation), per-user
   metrics of 1,024 users card vs plain within 1e-6, the items tied at
   the k-th place and the survivors of a column block at tau. AOBPR at its
   defaults (embed 64, batch 1,024, alpha 6,682): one epoch with a re-sort
   inside it, loss finite; evaluate() fused vs full within 1e-4 with
   dot_submax, dot_extract and rank_lookup_count launched. CML at its
   defaults (batch 256, dns 10): one epoch, loss finite, every trained
   user and item row within clip_norm, per-user metrics card vs plain
   within 1e-6. The phase prints its seconds.
9. Times on the card: each kernel, its plain version and a library call
   where one computes the same function, as device time per call
   (torch.profiler, REPS calls after warm-up) and as the median time of one
   call between CUDA events (host launch gaps included), and per call of
   200 back-to-back calls between CUDA events; the kernel's bound; the
   selection kernels (submax, kth_largest, extract, dot_submax,
   dot_extract) again at the evaluation shape (B=64, k=50) with their
   bounds (and torch.kthvalue beside kth_largest); vmem_topk (#5,
   pruned_merge's kernel at tau = -inf, its launches counted apart) at
   chunked evaluate()'s merge (B=64, W=100, k=50, beside torch.topk), its
   own row of the kernel record; direct_rank at
   the ML-1M evaluation shape with its found probes, by the profiler, by
   CUDA events over 1,000 back-to-back calls and for one call; recommend's p50 per batch size with the
   card's busy share during it (torch.profiler), for the score-matrix and
   the fused route; train steps/s, seconds per epoch and evaluation users/s
   (full, fused and chunked) for
   BPRMF (dense and lazy Adam; fused and chunked too), LightGCN and AOBPR
   (fused too), Pop, CML, LayerGCN, LightGCL, DENS, SelfCF, CDAE and
   MultVAE, FPMC and TransRec (dense and lazy Adam), SGAT, Caser and HGN
   (their other routes are timed in phases 10-12), with the busy share
   and the top device kernels of the first TRAIN_WINDOW steps of an epoch
   and of one evaluate() for the main path's models (BPRMF dense and
   lazy, LightGCN, AOBPR, the ML-1M-scale BPRMF); one
   BPRMF step with dense and with lazy Adam at the same batch, and
   dedup_rows at the step's 2,048 item rows.
10. The three other pairwise graph models on the phase-3 data, each at
   its published defaults (d=64, batch 2,048), each training through
   segsum on a path of its own. LayerGCN (4 layers) with dropout=0.1:
   the masks of epochs 0 (by degree) and 1 (at random) keep keep_len
   pairs in each half of the symmetric graph; fit() for 2 epochs. LightGCL
   (2 layers, SVD rank 5, rectangular R and R^T): fit() for one epoch.
   DENS (3 hops, ns "dens", K=1, 6 candidates): fit() for one epoch. Each
   fit(): losses finite, segsum launched exactly twice per propagation of
   a step and once per propagation of an evaluation, the full route's
   kernels launched. One train step of each model on the card against the
   same step on CPU copies of its parameters, Adam state, batch and masks
   (the masks drawn once; propagation through segsum's plain version):
   LayerGCN under epoch 0's pruning mask, LightGCL with dropout 0.25,
   DENS with edge and message dropout on; the loss within 1e-5 relative,
   every updated parameter within 1e-5 of its largest magnitude.
   evaluate(): finite metrics on the full route; LightGCL's and DENS's
   fused route within 1e-4 of it. The phase prints its seconds. It runs
   before phase 9, whose tables take its models.
11. SelfCF, CDAE and MultVAE on the phase-3 data, each at its published
   defaults. SelfCF (d=64, 2 layers, dropout 0.5, batch 2,048) trains
   through segsum under a fresh edge mask of random rate every step and
   scores one 128-wide concatenated dot; CDAE (hidden 64, dropout 0.5,
   num_neg 5, sigmoid, sigmoid cross-entropy, batch 256) and MultVAE
   (p_dims [64], keep_prob 0.5, anneal cap 0.2 over 200,000 steps, batch
   256) train on dense interaction rows built on the card and score as
   towers (their ``_topk_factors``, with a bias). fit() for one epoch
   each, cut to its first EPOCH_STEPS steps, on the captured route (the
   epoch a CUDA graph of one whole per-leaf dense-Adam step, its draws
   replayed from the epoch program's step generator, one replay a step,
   the warm-up steps and the capture under the host-read check): losses
   finite, segsum launched exactly 2 x 2 x (steps + warm-up steps) + 2
   for SelfCF and never for the others, the full route's kernels
   launched; MultVAE's step count equal to its steps (the warm-up's
   taken back); the derived tables after fit() (SelfCF's frozen
   embeddings, CDAE's and MultVAE's cached user vectors) those of the
   trained parameters. One train step of each on
   the card against the same step on CPU copies of its parameters, Adam
   state, batch and draws (drawn once: SelfCF's edge mask at the first
   seed whose rate is above 0.5, so that kept edges scale above 2, and
   its target masks; CDAE's negatives and dropout mask; MultVAE's
   dropout mask and eps at its anneal), the loss within 1e-5 relative,
   every updated parameter within 1e-5 of its largest magnitude. One
   cut epoch of each on each route from one state, bit-equal (loss,
   parameters, Adam's moments and counts, MultVAE's anneal count, both
   generators), with seconds and busy share, segsum among SelfCF's
   replayed kernels.
   evaluate() full, fused and chunked (8,192 items a chunk) for each:
   every route's kernels launched (dot_submax, dot_extract,
   kth_largest and rank_lookup_count on the fused one, vmem_topk on the
   chunked one), metrics within 1e-4 of the full route's. dot_submax and
   dot_extract against their plain versions with check_fused at B=64,
   k=50 on SelfCF's 128-wide factors and on CDAE's and MultVAE's tower
   factors with their bias. recommend() for 64 test users of each model
   equal to the plain top-k of its scores, no seen item. The phase prints
   its seconds; it runs before phase 9, whose tables take its models.
12. The sequential pairwise models on the phase-3 data, trained on the
   time-ordered examples of each user's training sequence, each at its
   published defaults for one fit() epoch cut to its first SEQ_STEPS
   steps: FPMC (d=64, one previous and
   one next item, batch 1,024), also one epoch with lazy Adam; TransRec
   (d=64), also one epoch with lazy Adam; SGAT (d=64, 5 layers, 5
   previous items pre-padded, 3 next), whose every step propagates the
   whole item-transition graph through segsum with its attention as traced
   per-edge weights; Caser (d=64, L=5, T=3, nv=4, nh=16, dropout 0.5) and
   HGN (d=64, L=5, T=3), towers over N + 1 columns (the pad scored 0),
   each also one epoch with lazy Adam cut to its first TRAIN_WINDOW
   steps (its
   tables' gathered rows; no table gradient formed).
   propagate_weighted on SGAT's graph with the first step's attention
   (layer 1 at the initial weights) and a seeded cotangent: the output and
   dx against segsum_plain in float64 on CPU copies (per row 1e-5 *
   sum|msg|), dw against a float64 (g[dst] . x[src]) within 1e-5 * sum|g_d
   x_d| an edge; its device times at that shape beside the bound,
   torch.sparse.mm of the CSR with the attention as values, and dw. fit():
   losses finite, segsum launched exactly 8 x 5 x (steps + warm-up steps)
   + 3 x 5 for SGAT (a layer of a step: its propagation forward and
   backward, the attention's two sums over fixed index sets forward and
   the gradients of its four fixed gathers backward; of an evaluation:
   the propagation and the two sums) and never for the others, the full
   route's kernels launched. FPMC's and TransRec's dense-Adam fit() and
   SGAT's on the captured route (the epoch a CUDA graph of one whole step
   on the flat parameter vector, replayed a batch: route, replays,
   warm-up steps and capture seconds printed; one capture, one replay a
   step; segsum's launches inside the replays counted a replay, the two
   warm-up steps before the capture launching as steps), the lazy-Adam
   ones on the eager route; after fit() the tables serving and evaluation
   derive (FPMC's concatenated tables, TransRec's and SGAT's user
   vectors) equal bit for bit those of the trained parameters and moved
   from before. One train step of each (dense Adam) on the card against the
   same step on CPU copies of its parameters, Adam state and batch
   (Caser's dropout mask drawn once; SGAT's propagation through segsum's
   plain version): the loss within 1e-5 relative, every parameter within
   1e-5 of its largest magnitude. evaluate() full and chunked for all
   five, fused for FPMC (its 128-wide concatenated dot), Caser (128 wide)
   and HGN: each route's kernels launched, metrics within 1e-4 of the
   full route's. Then for FPMC, TransRec and SGAT one cut epoch on the
   captured and one on the eager route from one state: loss, parameters,
   Adam's moments and step count bit-equal, the seconds and busy share of
   each route (segsum among SGAT's replayed kernels; epoch_routes).
   recommend() for 64 test users of each equal to the plain
   top-k of its scores, no seen item. It prints each model's epoch seconds
   and steps/s, the busy share and top device kernels of the first
   TRAIN_WINDOW steps of an SGAT epoch, and its seconds; it runs before phase 9, whose tables take its models.
13. The sequence towers on the phase-3 data, each built by name at its
   published defaults for one fit() epoch: GRU4Rec (layers [64], batch
   128, top1) and GRU4RecPlus (bpr_max, 2,048 sampled negatives a step),
   whose session-parallel walk (its schedule built on the host, ~5,500
   steps) trains TF-style GRU cells; SASRec (d=64, L=50, 2 blocks, 1
   head, dropout 0.5, batch 128); BERT4Rec (windows of 5, d=64, 2 heads,
   2 layers, batch 256, masked-LM over the catalog, optax's clipped AdamW
   with warm-up); SRGNN (d=64, 1 step, sessions of up to 200 items,
   batch 256, a (256, 200, 200) adjacency a step); GRU4Rec's and
   GRU4RecPlus's epochs are cut to the first WALK_WINDOW steps of their
   walks, BERT4Rec's and SRGNN's to their first TOWER_STEPS steps. fit():
   losses finite,
   the full route's kernels launched, segsum never. One train step of
   each on the card against the same step on CPU copies of its
   parameters, optimizer state, batch and draws (GRU4RecPlus's negatives,
   the dropout masks and BERT4Rec's masking uniforms drawn once;
   BERT4Rec's schedule past its warm-up): the loss within 1e-5 relative,
   every parameter within 1e-5 of its largest magnitude (an attention's
   key bias, whose gradient is rounding noise, of its key weight's).
   One bf16 step of SASRec and of BERT4Rec: finite, its loss within 5%
   of the f32 loss of the same batch. Each model's epoch seconds and
   steps/s, and the busy share and top device kernels of the first
   TRAIN_WINDOW steps of an epoch. evaluate() full, fused and chunked for
   each: each
   route's kernels launched, metrics within 1e-4 of the full route's.
   recommend() for 64 test users of each equal to the plain top-k of its
   scores, no seen item, the serving kernels launched; GRU4Rec also
   through the fused route (equal to dot_topk's plain version, its
   kernels launched). It prints its seconds; alone: `python3
   experiments/chip_phase13.py`.
14. The multimodal models on the phase-3 data with 4,096-d image and
   384-d text item features written by the port's generator. The kNN
   selection (row chunks of the normalised features' similarities, each
   row's top 10 by blockwise_topk, kernels #1-#4) of both tables, timed,
   against float64 on the CPU on 256 sampled rows: a neighbour may differ
   only where its similarity is within 1e-5 of the row's 10th; the
   selected similarities within 1e-5 of float64. BM3 (d=64, 1 layer,
   dropout 0.3, cl_weight 2.0), SLMRec (d=64, 3 layers, FAC, concat,
   "pre"), FREEDOM (d=64, k=10, 1 item-graph and 2 user-item layers,
   image weight 0.1, dropout 0.8), MGCN (d=64, 2 user-item and 1 item
   layers, k=10, cl 0.001) and LATTICE (d=64, k=10, lambda 0.9, 1 layer,
   lightgcn, lr 1e-4), each built by name at its defaults with batch
   2,048 (its kNN graphs built on the card, launches counted) for one
   fit() epoch cut to its first MM_STEPS steps: losses finite, segsum
   launched exactly its propagations forward and backward each step and
   once an evaluation (LATTICE also its learned graph's row sums over a
   fixed index set, at an epoch's first step and at each evaluation),
   LATTICE's learned graph through blockwise_topk (pruned_merge launched
   in its fit()). BM3's, SLMRec's and MGCN's fit() on the captured route
   (BM3's and SLMRec's per-leaf step with BM3's table-wide masks drawn
   from the program's step generator; MGCN's whole nested tree one flat
   vector, the 4,096-d table included, its LambdaLR rate computed inside
   the step from Adam's count over the whole epoch's steps; segsum's
   launches counted as phase 12's), their frozen embeddings after fit()
   those of the trained parameters; one cut epoch of each on each route
   from one state, bit-equal, with seconds and busy share, segsum among
   the replayed kernels. One train step of each on the card
   against the same step on CPU copies of its parameters, Adam state,
   batch and draws (BM3's table-wide target masks, FREEDOM's epoch mask,
   MGCN at the rate its schedule gives on the card; LATTICE's epoch-first
   step, the item weights built with gradient on the card's selection of
   neighbours): the loss within 1e-5 relative, every parameter within
   1e-5 of its largest magnitude.
   evaluate() full, fused and chunked (SLMRec, whose score is a sigmoid,
   full and chunked): each route's kernels launched, metrics within 1e-4
   of the full route's. recommend() for 64 test users of each equal to
   the plain top-k of its scores, no seen item. Each model's epoch
   seconds and steps/s, the busy share and top device kernels of the
   first TRAIN_WINDOW steps of an epoch, LATTICE's peak device memory,
   and the
   phase's seconds; alone: `python3 experiments/chip_phase14.py`.

15. The command line on the phase-3 data, from a scratch working
   directory. (a) The user's command as a subprocess, `python3
   run_skrx_torch.py --recommender LightGCN --data_dir <dir> --epochs 1
   --early_stop 1 --top_k "(10,20)" --metric "('Recall','NDCG')"`
   (LightGCN at its defaults: d=64, 3 layers, batch 1,024; test batch
   64): exit 0, its log under log/<data>/LightGCN/. (b) The same argv
   through run_skrx_torch.main(argv) in this process, launches counted:
   segsum, submax, kth_largest, extract and rank_count each launched;
   its metrics within 1e-6 of (a)'s logged ones and of a LightGCN built
   by hand and fit() (bit-equality printed). (c) `--config run.ini` with
   MultVAE, the ini setting compute_dtype bfloat16, epochs 1 and an lr
   that a CLI --lr overrides: the model's log shows both, the metrics
   finite; BPRMF with --compute_dtype bfloat16 warns and runs. (d) A user
   model, unarchived_models/BPRMFGrid.py (the port's BPRMF with a
   two-point lr grid), with --hyperopt True: the grid fallback (no
   hyperopt library) logs 2 trial rows and the best parameters, and
   returns the best trial's NDCG@10. (e) The command of (a) under
   CUDA_VISIBLE_DEVICES="" exits non-zero with the device error. It
   prints each check and its seconds; alone: `python3
   experiments/chip_phase15.py`.
16. The mesh (skrx_torch/parallel/) on the phase-3 data, its ranks
   sharing the one card over gloo (NCCL refuses two ranks on one GPU),
   spawned after the kernels are built. (a) 2 ranks on cuda:0: the
   backend each chose (gloo), the world and each rank's device. (b) The
   sharded propagate on the LightGCN graph at D=64 (its destination rows
   split in two), forward and the gradient of a seeded cotangent, against
   propagate on one device: within 1e-5 of the output's scale, segsum
   launched once forward and once backward on each rank. (c)
   sharded_dot_topk at B=64, k=50, d=64 over the 40,981 items (2 shards)
   with a train table, against topk_scores_and_indices of the whole
   score matrix: values within 1e-5 of their scale, ids equal but for
   near ties at the k-th place (counted), #1-#4 and #5 launched on each
   rank. (d) LightGCN at its defaults with batch 2,048 on (1, 2), one
   fit() epoch cut to its first MESH_GCN_STEPS steps (the pipeline's
   num_batches), against a single-device LightGCN at the same seed and
   cut: the epoch loss within 1e-5 relative, every parameter within 1e-5
   of its table's scale, evaluate() through "topk" within 1e-4 of the
   single device's "full" (rank_count never launched), segsum launched
   exactly steps x 2 x 3 + 3 times on each rank, #1-#5 launched. (e)
   BPRMF at its defaults on (2, 2), 4 ranks, one epoch cut to
   MESH_BPR_STEPS steps, against one device the same way. (f) The
   user's command, `torchrun --standalone --nproc_per_node 2
   run_skrx_torch.py --recommender LightGCN --mesh_shape "(1,2)" --epochs
   1 ...` (batch MESH_CLI_BATCH so that its epoch fits the phase), as a
   subprocess: exit 0, one log, rank 0's, with finite metrics. (g) The
   phase's and the epochs' seconds, each labelled with the ranks that
   shared the card. The tally adds the single-device runs' and every
   rank's launches. Alone: `python3 experiments/chip_phase16.py`.
17. Every other model on the mesh: 4 ranks of a (2, 2) mesh sharing the
   card over gloo, spawned once, run in turn the 24 models that phase 16
   leaves out (Pop, AOBPR, CML, the graph family DENS, SelfCF, LayerGCN,
   LightGCL, BM3, SLMRec, FREEDOM, MGCN, LATTICE, the towers CDAE,
   MultVAE, FPMC, TransRec, SGAT, Caser, HGN, GRU4Rec, GRU4RecPlus,
   SASRec, BERT4Rec, SRGNN) and BPRMF with lazy Adam, each at its
   default config widths on phase 14's data (phase 3's with the 4,096-d
   image and 384-d text features) and one seed: a fit() epoch cut to
   P17_STEPS steps (fewer for the models whose step all-reduces a
   replicated or gathered 4,096-wide feature table through the host,
   P17_FEW), its evaluate() through "topk" over P17_EVAL_USERS test
   users (rank_count never launched); then, the 4 ranks at once, each
   runs the same steps on one device of every 4th model and holds the
   mesh model to it: the epoch loss within 1e-4 relative, every
   parameter, gathered whole, within 1e-4 of its 2-norm (the greatest
   entry gap printed; the biases of exactly zero gradient, P17_NOISE,
   reported), the metrics within 1e-4. P17_TWICE's models run one device
   twice, which must give bit-equal parameters and losses; P17_REORDER's
   a third time with each step's batch in reverse order, and their loss
   and parameter bounds are P17_ORDER_MULT times that run's gaps, 1e-4 at
   the least (the comment above P17_TWICE says why).
   Every rank's predict_topk over P17_TOPK_USERS users against the
   masked top-k of its predict: values within 1e-5 of the scores' scale
   (the largest finite |score| of the rows), an id different only where
   predict scores it that near its place's value (a near tie). Every rank launches
   segsum (#11) in each graph model's fit() and #1-#5 in each
   predict_topk. It prints each model's step seconds on the mesh and on
   one device, the greatest parameter gap and the metric gap with the
   card's name and power limit. Alone: `python3
   experiments/chip_phase17.py`.
18. The long-run sweep (scripts/longrun_torch.py) cut to fit the run:
   its data (500 users, 800 items, 20,000 ratings with latent user-item
   structure, item features; the port's copy of JAX's generator) and the
   ten models of its SWEEP (BPRMF, MultVAE, GRU4Rec, SASRec, BERT4Rec,
   Caser, CML, LightGCN, LightGCL, BM3) at run seed 2021, each at P18's
   widths for P18's epochs with an evaluation after each (NDCG@10, test
   batch 256). No loss NaN; the best NDCG@10 through the cut of each model
   at the sweep's widths within the JAX reference's interval for one seed
   at the same cut (experiments/longrun_reference.json: JAX's seeds
   2021-2023 on the CPU, [min - m, max + m], m = max(r, 0.05 mu)); GRU4Rec
   runs at its defaults, where it learns, and its best is printed beside
   JAX's, not checked (P18 says why); segsum (#11) launched in LightGCN's,
   LightGCL's and BM3's fit(), and a rank kernel at least once an
   evaluation in every fit(). BPRMF and GRU4Rec run twice from the same
   seed, and every epoch's NDCG@10 must be the same in both runs. It prints each model's best, its epoch
   and seconds an epoch with the card's name and power limit. Alone:
   `python3 experiments/chip_phase18.py`.

Before them it prints each phase's seconds and the whole run's. The
second-to-last line is the per-kernel JSON record (one row for each of the
11 TPU kernels), the last line ``{"ok": true, "device": {...}}``.
"""
import atexit
import gc
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.eval import EarlyStopping
from skrx_torch.io import RSDataset, synthetic
from skrx_torch.models.BPRMF import bprmf_lazy_train_step
from skrx_torch.models.CDAE import cdae_draws, cdae_loss
from skrx_torch.models.Caser import caser_keep_mask, caser_loss
from skrx_torch.models.DENS import dens_dropout_masks, dens_loss
from skrx_torch.models.BERT4Rec import bert4rec_draws, bert4rec_loss
from skrx_torch.models.BM3 import bm3_draws, bm3_loss
from skrx_torch.models.FREEDOM import freedom_loss
from skrx_torch.models.FPMC import fpmc_loss
from skrx_torch.models.GRU4Rec import gru4rec_loss, walker_num_steps
from skrx_torch.models.HGN import hgn_loss
from skrx_torch.models.LATTICE import lattice_item_graph, lattice_loss
from skrx_torch.models.LayerGCN import layergcn_loss
from skrx_torch.models.LightGCL import lightgcl_dropout_masks, lightgcl_loss
from skrx_torch.models.LightGCN import lightgcn_loss
from skrx_torch.models.MGCN import MGCNGraphs, mgcn_loss
from skrx_torch.models.MultVAE import multvae_draws, multvae_loss
from skrx_torch.models.SASRec import sasrec_draws, sasrec_loss
from skrx_torch.models.SGAT import (head_embedding, sgat_attention, sgat_loss,
                                    sgat_propagate)
from skrx_torch.models.SLMRec import slmrec_draws, slmrec_loss
from skrx_torch.models.SRGNN import srgnn_loss
from skrx_torch.models.SelfCF import selfcf_draws, selfcf_loss
from skrx_torch.models.TransRec import transrec_loss
from skrx_torch.models.common import adam_l2, make_train_step, nest_params
from skrx_torch.models.pipeline import epoch_generator
from skrx_torch.ops import metrics
from skrx_torch.ops.graph import (graph_from_coo, propagate,
                                  propagate_weighted)
from skrx_torch.ops.kernels import _build, runtime
from skrx_torch.ops.kernels import dot_topk as dt
from skrx_torch.ops.kernels import segsum as ss
from skrx_torch.ops.mm_graph import knn_select
from skrx_torch.ops.kernels import topk_blocks as tb
from skrx_torch.ops.optim import LazyAdam, OptaxAdamW, dedup_rows
from skrx_torch.ops import scatter
from skrx_torch.parallel import (ShardedPropGraph, make_mesh, pad_rows,
                                 run_ranks, sharded_dot_topk)
from skrx_torch.serve import TopKRecommender
from skrx_torch.utils.checkpoint import Checkpointer
from skrx_torch.utils.chip import PEAKS, card_line, chip_peaks
import run_skrx_torch

USERS, ITEMS, RATINGS, DIM, K = 29_858, 40_981, 1_027_370, 64, 10
# MovieLens-1M's published counts: the small-catalog route
ML_USERS, ML_ITEMS, ML_RATINGS = 6_040, 3_706, 1_000_209
BATCHES = (1, 16, 64, 256, 1024)
B_KERNEL = 1024
B_EVAL = 64                       # RunConfig.test_batch_size default
K_EVAL = 50                       # max of RunConfig.top_k default
EPOCHS = 2
BLOCK_N = 4096
BPRMF_TABLES = ("user_emb", "item_emb", "item_bias")
SEED = 2021
SERVING = ("submax", "kth_largest", "extract", "pruned_merge")
EXPORT_B = 64                     # scripts/bench_serve.py's export batch
SOURCE = {name: "skrx_torch/ops/kernels/csrc/topk_blocks.cu"
          for name in SERVING + ("vmem_topk",)}
SOURCE.update(rank_count="skrx_torch/ops/kernels/csrc/rank_counts.cu",
              rank_lookup_count="skrx_torch/ops/kernels/csrc/rank_counts.cu",
              direct_rank="skrx_torch/ops/kernels/csrc/rank_counts.cu",
              dot_submax="skrx_torch/ops/kernels/csrc/dot_topk.cu",
              dot_extract="skrx_torch/ops/kernels/csrc/dot_topk.cu",
              segsum="skrx_torch/ops/kernels/csrc/segsum.cu")
REPLACES = {"submax": "skrx/ops/pallas/topk_blocks.py:488",
            "kth_largest": "skrx/ops/pallas/topk_blocks.py:224",
            "extract": "skrx/ops/pallas/topk_blocks.py:601",
            "pruned_merge": "skrx/ops/pallas/topk_blocks.py:295",
            "vmem_topk": "skrx/ops/pallas/topk_blocks.py:145",
            "rank_count": "skrx/ops/pallas/topk_blocks.py:815",
            "rank_lookup_count": "skrx/ops/pallas/topk_blocks.py:872",
            "direct_rank": "skrx/ops/pallas/topk_blocks.py:935",
            "dot_submax": "skrx/ops/pallas/dot_topk.py:109",
            "dot_extract": "skrx/ops/pallas/dot_topk.py:115",
            "segsum": "skrx/ops/pallas/segsum_mxu.py:203"}
GCN_SERVE = (1, 64, 1024)
FUSED = ("dot_submax", "dot_extract")
BIG_ITEMS, BIG_B = 1_048_576, 256       # the catalog only fused serves cheaply
CHUNK = 8_192
# The run's depth: steps, test users and repetitions, cut so that the whole
# script takes about half of its time limit. FULL_DEPTH holds each one's
# value before that cut; experiments/chip_phaseNN.py runs a phase at it
# (full_depth()), and a phase's spawned ranks take the spawning process's
# values (depth()). None: every step or every test user.
REPS = 10                         # calls a kernel time is taken over
TRAIN_WINDOW = 8                  # steps of an epoch under the profiler
WALK_WINDOW = 200                 # steps of GRU4Rec's, GRU4RecPlus's epoch
TOWER_STEPS = 100                 # steps of BERT4Rec's and SRGNN's epoch
# steps of phase 12's epochs (FPMC, TransRec, SGAT, Caser, HGN); on an
# H100, 20 made the step check after them fail (TransRec's user_emb 6.5e-7
# against a bound of 1.35e-7: Adam's state after few steps magnifies the
# gradients' rounding), 40 holds it within 4.7e-9
SEQ_STEPS = 40
# steps of phase 14's epochs (BM3, SLMRec, FREEDOM, MGCN, LATTICE)
MM_STEPS = 40
# steps of the epochs of phases 8, 10 and 11 (lazy-Adam BPRMF, AOBPR past
# its first re-sort, LayerGCN, LightGCL, DENS, SelfCF, CDAE, MultVAE)
EPOCH_STEPS = 150
# test users of every evaluation of the models of phases 8 and 10-14 (the
# first EVAL_USERS by id; Pop's and CML's metrics checks take all)
EVAL_USERS = 4_096
# calls of the latency and busy-share loops of phase 9
LATENCY_CALLS = 15
IMG_DIM, TXT_DIM = 4_096, 384     # VGG image, sentence-transformer text
KNN_K = 10                        # the kNN graphs' k
KNN_ROWS = 128                    # rows held to float64
MSG = {"f32": torch.float32, "bf16": torch.bfloat16}
# F, the most survivors of a block that extract ranks directly
# (csrc/topk_blocks.cu kRankCap)
RANK_CAP = 256
# F of pruned_merge, the most survivors of a row it ranks directly
# (csrc/topk_blocks.cu kMergeCap)
MERGE_CAP = 256
# the card's data sheet (skrx_torch/utils/chip.py): f32 outside the tensor
# cores and device-memory bytes/s; main() takes them for the card it finds
_, F32_OPS, MEM_RATE = PEAKS["NVIDIA H100 80GB HBM3"]
# phase 16: the steps of the sharded epochs (of 358 at LightGCN's batch of
# 2,048 and 716 at BPRMF's 1,024; the pipeline's num_batches) and the
# command line's batch, so that the phase stays near 150 s
MESH_GCN_STEPS = 10
MESH_BPR_STEPS = 10
MESH_CLI_BATCH = 32_768
# phase 17: the steps of each model's cut epoch on (2, 2), fewer where a
# step moves a 4,096-wide feature table (671 MB) through gloo's host
# staging, and the users of its evaluate() and of predict_topk
P17_STEPS = 5
P17_FEW = {"DENS": 3, "LayerGCN": 3, "LightGCL": 3, "SLMRec": 3,
           "BM3": 2, "FREEDOM": 2, "MGCN": 1, "LATTICE": 2, "MultVAE": 3}
P17_EVAL_USERS = 256
P17_TOPK_USERS = 64
P17_MODELS = ("Pop", "AOBPR", "CML", "DENS", "SelfCF", "LayerGCN",
              "LightGCL", "CDAE", "MultVAE", "FPMC", "TransRec", "SGAT",
              "Caser", "HGN", "GRU4Rec", "GRU4RecPlus", "SASRec",
              "BERT4Rec", "SRGNN", "BM3", "SLMRec", "FREEDOM", "MGCN",
              "LATTICE", "BPRMF")
P17_CONFIG = {"LayerGCN": {"dropout": 0.1}, "BPRMF": {"optimizer":
                                                      "lazy_adam"}}
P17_GRAPH = ("DENS", "SelfCF", "LayerGCN", "LightGCL", "BM3", "SLMRec",
             "LATTICE")
# the gap allowed after the cut epoch, |mesh - one device| over |one
# device| of each parameter (2-norms), and of the epoch loss (relative):
# 1e-4 (the CPU tests hold every entry within 1e-5 of its table's scale).
# Every sum of the train path runs in one fixed order, so P17_TWICE's
# models, run twice on one device, must give bit-equal parameters and
# losses. The mesh still sums a step's gradients in another order than
# one device by design (each data index's rows, then the all-reduce over
# the data axis), and an entry whose gradient cancels to rounding (an item
# bias the batch pushes both ways: GRU4Rec's TOP1 and GRU4RecPlus's
# BPR-max gradients of many biases cancel to ~1e-9 at their initial
# weights, near Adam's eps) takes Adam's whole step on that rounding's
# sign. For P17_REORDER's models one device runs a third time with each
# step's batch in reverse order (GRU4Rec's lanes, AOBPR's rows: the same
# examples and draws, every sum over the batch in another order), and
# their bound is P17_ORDER_MULT times that run's gap, 1e-4 at the least:
# both gaps are the steps of the entries whose near-zero gradients change
# sign under a new rounding, and 4 lets the mesh's perturbation flip up to
# 16 times as many entries as the reversal's (a norm gap grows as the
# square root of their count)
P17_TWICE = ("AOBPR", "GRU4Rec", "GRU4RecPlus", "SASRec", "SGAT")
P17_REORDER = ("AOBPR", "GRU4Rec", "GRU4RecPlus")
P17_ORDER_MULT = 4.0
# biases whose exact gradient is 0 (each shifts every logit of a softmax
# row alike), moved only by rounding noise that Adam magnifies
P17_NOISE = {"SASRec": ("blocks.{}.att.k.b",), "BERT4Rec": ("blocks.{}.k.b",),
             "SLMRec": ("g_v_iv.b", "g_t_ivat.b")}
# phase 18: each model of the long-run sweep at the sweep's widths and its
# epochs cut so that the phase stays near 40 s on an H100 (the sweep itself
# runs 100-150), its best held to JAX's seeds at the same cut. GRU4Rec
# runs at its ModelConfig defaults instead, for the 6 epochs by which
# JAX's defaults run reached its best of 100, with its NaN and launch
# checks only: at the sweep's widths it scores at chance in both packages
# (NDCG@10 ~0.01, no trend), and at its defaults the reference holds one
# JAX seed, whose interval JAX's own seeds 2022-2024 fall below
# (experiments/longrun_seeds_jax.py)
P18 = {"BPRMF": ("sweep", 10), "MultVAE": ("sweep", 20),
       "GRU4Rec": ("default", 6), "SASRec": ("sweep", 20),
       "BERT4Rec": ("sweep", 10), "Caser": ("sweep", 10),
       "CML": ("sweep", 20), "LightGCN": ("sweep", 20),
       "LightGCL": ("sweep", 10), "BM3": ("sweep", 20)}
P18_TWICE = ("BPRMF", "GRU4Rec")
# the depth before the cut (see REPS)
FULL_DEPTH = {"REPS": 20, "TRAIN_WINDOW": 8, "WALK_WINDOW": 600,
              "TOWER_STEPS": 300, "SEQ_STEPS": 80, "MM_STEPS": 120,
              "EPOCH_STEPS": None, "EVAL_USERS": None, "LATENCY_CALLS": 35,
              "KNN_ROWS": 256,
              "MESH_GCN_STEPS": 10, "MESH_BPR_STEPS": 25, "P17_STEPS": 20,
              "P17_FEW": {"DENS": 10, "LayerGCN": 10, "LightGCL": 10,
                          "SLMRec": 10, "BM3": 3, "FREEDOM": 3, "MGCN": 2,
                          "LATTICE": 3, "MultVAE": 8},
              "P17_EVAL_USERS": 1_024, "P17_TOPK_USERS": 64}
NEG_INF = float("-inf")
INT_MIN = -2 ** 31                      # -0.0 as int32


def full_depth() -> None:
    """Run every phase at FULL_DEPTH from now on."""
    globals().update(FULL_DEPTH)


def depth() -> dict:
    """The depth settings now in force, by name (FULL_DEPTH's names)."""
    return {name: globals()[name] for name in FULL_DEPTH}


def cut_epoch(m, steps):
    """Cut model m's epochs to their first ``steps`` steps (None: all);
    returns the steps an epoch runs (0 for Pop, which trains nothing)."""
    if hasattr(m, "step_limit"):                  # GRU4Rec's walk
        m.step_limit = steps
        return steps
    # AOBPR and SRGNN count their own steps, the rest their pipeline's
    owner = m if hasattr(m, "num_batches") else getattr(m, "pipeline", None)
    if owner is None:
        return 0
    if steps is not None:
        owner.num_batches = min(steps, owner.num_batches)
    return owner.num_batches


def cut_eval(m, users=None):
    """Hold model m's evaluations to its first ``users`` test users by id
    (EVAL_USERS when None; all when that is None too)."""
    users = users or EVAL_USERS
    if users is None:
        return m
    test = m.evaluator.user_pos_test
    m.evaluator.set_test_data({u: test[u] for u in sorted(test)[:users]})
    return m


def require(ok: bool, what: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def same(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """got == ref entrywise, NaN equal to NaN (by isnan, not by payload:
    JAX's and the kernels' NaN bits are their own)."""
    eq = got == ref
    return eq | (got.isnan() & ref.isnan()) if got.is_floating_point() else eq


def same_bits(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """f32 tensors equal as int32 views (so -0.0 differs from +0.0), NaN
    equal to NaN by isnan."""
    got, ref = got.cpu(), ref.cpu()
    nan = ref.isnan()
    return (torch.equal(got.isnan(), nan)
            and torch.equal(got.view(torch.int32)[~nan],
                            ref.view(torch.int32)[~nan]))


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| with equal entries (-inf and NaN included)
    counted 0."""
    got, ref = got.cpu().double(), ref.cpu().double()
    diff = torch.where(same(got, ref), torch.zeros_like(got),
                       (got - ref).abs())
    return float(diff.max()) if diff.numel() else 0.0


def expect_equal(what: str, got, ref, errs: dict, key: str) -> None:
    """Values (and int ids) of the kernel equal the plain version's, NaN
    equal to NaN by isnan."""
    for g, r in zip(got, ref):
        g = g.cpu()
        require(g.shape == r.shape and g.dtype == r.dtype,
                f"{what}: {g.shape} {g.dtype} != {r.shape} {r.dtype}")
        # == on floats: -inf equals -inf, -0.0 equals +0.0 (ids decide ties)
        require(bool(same(g, r).all()), f"{what}: kernel != plain (max abs "
                                        f"err {max_err(g, r)})")
        if g.dtype == torch.float32:
            errs[key] = max(errs.get(key, 0.0), max_err(g, r))


def check_chain(what: str, scores, mask, k: int, errs: dict,
                block_n: int = BLOCK_N):
    """Run the four kernels of blockwise_topk on the card and each plain
    version on CPU copies of the same inputs; returns the card's tensors."""
    s_cpu = scores.cpu()
    m_cpu = None if mask is None else mask.cpu()
    bm = tb.submax(scores, mask, block_n)
    expect_equal(f"{what} submax", [bm],
                 [tb.submax_plain(s_cpu, m_cpu, block_n)], errs, "submax")
    bmf = tb.fold_submaxes(bm, k).contiguous()
    tau = tb.kth_largest(bmf, k)
    tau_ref = tb.kth_largest_plain(bmf.cpu(), k)
    expect_equal(f"{what} kth_largest", [tau], [tau_ref], errs, "kth_largest")
    expect_equal(f"{what} kth_largest bits", [tau.view(torch.int32)],
                 [tau_ref.view(torch.int32)], errs, "kth_largest")
    cv, ci = tb.extract(scores, tau, k, mask, block_n)
    expect_equal(f"{what} extract", [cv, ci],
                 tb.extract_plain(s_cpu, m_cpu, tau.cpu(), k, block_n), errs,
                 "extract")
    mv, mi = tb.pruned_merge(cv, ci, k, tau)
    expect_equal(f"{what} pruned_merge", [mv, mi],
                 tb.pruned_merge_plain(cv.cpu(), ci.cpu(), k, tau.cpu()), errs,
                 "pruned_merge")
    vv, vi = tb.vmem_topk(cv, ci, k)
    expect_equal(f"{what} vmem_topk", [vv, vi],
                 tb.pruned_merge_plain(cv.cpu(), ci.cpu(), k,
                                       torch.full_like(tau.cpu(), NEG_INF)),
                 errs, "vmem_topk")
    require(torch.equal(vv.cpu(), mv.cpu())
            and torch.equal(vi.cpu(), mi.cpu()),
            f"{what}: vmem_topk != pruned_merge")
    return bmf, tau, cv, ci


def adversarial(dev, errs: dict) -> None:
    rng = np.random.default_rng(SEED)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    # tie storm: constant rows with one high column, lightly masked
    s = np.zeros((64, ITEMS), np.float32)
    s[:, 700] = 2.0
    s[1:8] = np.round(rng.standard_normal((7, ITEMS)))       # many ties
    mask = np.full((64, 8), ITEMS, np.int32)
    mask[:, 0] = 0
    check_chain("tie storm", t(s), t(mask), K, errs)
    # fully masked rows, rows with < k unmasked or finite items, -inf rows
    n = 8192
    s = rng.standard_normal((8, n)).astype(np.float32)
    mask = np.full((8, n), n, np.int32)
    mask[0] = np.arange(n)
    mask[1, :n - 4] = rng.permutation(n)[:n - 4]
    s[2] = NEG_INF
    s[3, 5:] = NEG_INF
    mask[4, :5] = [-1, n + 3, 7, 7, n - 1]
    check_chain("masked/-inf rows", t(s), t(mask), K, errs)
    check_chain("masked/-inf rows k=50", t(s), t(mask), 50, errs)
    # duplicate (value, id) candidates and value ties for the merge
    w = 300
    vals = np.round(rng.standard_normal((64, w)) * 2).astype(np.float32)
    ids = np.stack([rng.permutation(w) for _ in range(64)]).astype(np.int32)
    vals[:, :6], ids[:, :6] = vals[:, 6:7], ids[:, 6:7]
    vals[5, 10:] = NEG_INF
    tau = torch.full((64,), NEG_INF)
    got = tb.pruned_merge(t(vals), t(ids), K, tau.to(dev))
    expect_equal("duplicate candidates", got,
                 tb.pruned_merge_plain(t(vals).cpu(), t(ids).cpu(), K, tau),
                 errs, "pruned_merge")
    kth_adversarial(dev, errs)
    extract_adversarial(dev, errs)
    merge_adversarial(dev, errs)
    submax_nan_adversarial(dev, errs)


def submax_rows(rng, n: int, block_n: int):
    """(scores (8, n), mask table (8, n)): rows built to break submax's max
    as JAX's fold (jnp.maximum) takes it, NaN when a group holds one and
    -0.0 below +0.0. With t a column's place in its group ((c % block_n) //
    128): row 0 +0.0 at t = 0 and -0.0 after it, row 1 -0.0 before a +0.0
    at the last t, row 2 -0.0 only, row 3 zeros of either sign among
    negatives, row 4 NaN of either sign in one column in 500 (at least 4),
    row 5 +inf at t = 0 and NaN at the last t, row 6 normals and -inf, row
    7 fully masked. Mask rows 0-6: 40 ids of [-3, n + 3) (out of range
    ids, duplicates), then padding (n)."""
    s = rng.standard_normal((8, n)).astype(np.float32)
    c = np.arange(n)
    t = (c % block_n) // 128
    # the column at its group's last place (its block may be narrower)
    last = c % block_n + 128 >= np.minimum(block_n, n - c // block_n * block_n)
    s[0] = np.where(t == 0, 0.0, -0.0)
    s[1] = np.where(last, 0.0, -0.0)
    s[2] = -0.0
    zero = rng.random(n) < 0.3
    s[3] = np.where(zero, np.where(rng.random(n) < 0.5, 0.0, -0.0),
                    -np.abs(s[3]))
    nan = rng.choice(n, max(4, n // 500), replace=False)
    s[4, nan] = np.where(rng.random(len(nan)) < 0.5, np.nan, -np.nan)
    s[5, t == 0] = np.inf
    s[5, last] = np.nan
    s[6, rng.random(n) < 0.5] = NEG_INF
    mask = np.full((8, n), n, np.int32)
    mask[:7, :40] = rng.integers(-3, n + 3, (7, 40))
    mask[7] = np.arange(n)
    return s, mask


def submax_nan_adversarial(dev, errs: dict) -> None:
    """submax on submax_rows at block_n in {4,096, 256, 128} over the
    Gowalla catalog (a last block of 21 columns at 4,096) and N = 1,000,
    with and without the mask table: equal to submax_plain as int32 views
    (signed zeros count), NaN by isnan."""
    rng = np.random.default_rng(SEED + 9)
    for n in (ITEMS, 1000):
        for block_n in (BLOCK_N, 256, 128):
            s, mask = (torch.from_numpy(x) for x in submax_rows(rng, n,
                                                                 block_n))
            for m in (mask, None):
                got = tb.submax(s.to(dev), None if m is None else m.to(dev),
                                block_n)
                ref = tb.submax_plain(s, m, block_n)
                require(same_bits(got, ref),
                        f"submax N={n} block_n={block_n} mask="
                        f"{m is not None}: kernel != plain")
                require(bool((ref[1].view(torch.int32) == 0).any())
                        and bool((ref[2].view(torch.int32) == INT_MIN).any())
                        and bool(ref[4].isnan().any())
                        and bool(ref[5].isnan().any()),
                        "submax rows hold +0.0, -0.0 and NaN groups")
                errs["submax"] = max(errs.get("submax", 0.0),
                                     max_err(got, ref))


def kth_rows(rng, w: int) -> np.ndarray:
    """(11, w) f32 rows built to break a selection of the k-th largest (k
    in {1, 10, 50, W}): ties across the k-th place, all -inf, negatives
    only, signed zeros and subnormals, 5 finite entries, +inf, one value.
    The tests of kth_largest use them too."""
    x = rng.standard_normal((11, w)).astype(np.float32)
    x[1] = np.round(x[1] * 2)
    x[2, rng.choice(w, min(w, 60), replace=False)] = 3.0   # places 1..60 tie
    x[3] = NEG_INF
    x[4] = -np.abs(x[4]) - 1.0
    x[5] = np.where(rng.random(w) < 0.5, -0.0, 0.0)
    x[5, :4] = [1e-40, -1e-40, 1e-45, -1e-45]
    x[6] = -0.0
    x[6, :20] = 0.0
    x[7, 5:] = NEG_INF
    x[8] = rng.standard_normal(w) * 1e-39                  # subnormals only
    x[9, :3] = np.inf
    x[10] = 0.25
    return x


def kth_adversarial(dev, errs: dict) -> None:
    """kth_largest at every instantiation's width and past the widest
    (5,000 reads the row each round), k in {1, 10, 50, W}: bits equal to
    the plain version's (torch.equal of the int32 views)."""
    rng = np.random.default_rng(SEED + 5)
    for w in (128, 256, 1408, 4096, 5000):
        x = torch.from_numpy(kth_rows(rng, w))
        xd = x.to(dev)
        for k in sorted({1, min(10, w), min(50, w), w}):
            got = tb.kth_largest(xd, k).cpu()
            ref = tb.kth_largest_plain(x, k)
            require(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                    f"kth_largest W={w} k={k}: kernel != plain")
            errs["kth_largest"] = max(errs.get("kth_largest", 0.0),
                                      max_err(got, ref))


def extract_rows(rng, k: int, block_n: int = BLOCK_N):
    """(scores (R, N), mask table (R, 8), tau (R,), founds): rows built to
    break extract's selection, N = 2 block_n + 100 (a ragged third block).
    Block 0 of row r < len(founds) holds exactly founds[r] survivors (at
    or above tau = 1.0, ties among them, three more masked away): 0, 1, 31,
    32, 33 (one warp and past it), k - 1, k, k + 1, and F, F + 1 (the most
    extract ranks directly, csrc/topk_blocks.cu kRankCap); its other blocks
    a few survivors and -inf columns. Then a row whose block 1 is tau in
    every column, and one of +0.0 and -0.0 ties at tau = +0.0 (300 in block
    0, past F; 40 in block 1). The tests of extract use them too."""
    founds = sorted({0, 1, 31, 32, 33, k - 1, k, k + 1, RANK_CAP,
                     RANK_CAP + 1})
    n = 2 * block_n + 100
    rows = len(founds) + 2
    s = rng.uniform(-3.0, 0.99, (rows, n)).astype(np.float32)
    tau = np.ones(rows, np.float32)
    mask = np.full((rows, 8), n, np.int32)
    mask[:, 5:] = [-1, n + 7, 2 * block_n + 3]   # padding, out of range, real
    for r, f in enumerate(founds):
        cols = rng.choice(block_n, f + 3, replace=False)
        s[r, cols] = 1.0 + np.round(rng.random(f + 3) * 4) / 4
        mask[r, :3] = cols[:3]
        later = block_n + rng.choice(n - block_n, 60, replace=False)
        s[r, later[:40]] = NEG_INF
        s[r, later[40:]] = 1.5
    r = len(founds)
    s[r, block_n:2 * block_n] = tau[r]
    r += 1
    tau[r] = 0.0
    s[r] = -1.0
    s[r, :300] = np.where(rng.random(300) < 0.5, -0.0, 0.0)
    s[r, block_n:block_n + 40] = np.where(rng.random(40) < 0.5, -0.0, 0.0)
    return s, mask, tau, founds


def extract_adversarial(dev, errs: dict) -> None:
    """extract on extract_rows at k = 10 and 50: values (as int32, so signed
    zeros count) and ids equal to extract_plain's."""
    rng = np.random.default_rng(SEED + 6)
    for k in (K, K_EVAL):
        s, mask, tau, founds = extract_rows(rng, k)
        s_t, m_t, tau_t = (torch.from_numpy(x) for x in (s, mask, tau))
        found = ((tb._masked_padded(s_t, m_t, BLOCK_N)[:, :BLOCK_N]
                  >= tau_t[:, None]).sum(1))
        require(found[:len(founds)].tolist() == founds,
                f"extract rows: block 0 holds {found.tolist()} survivors")
        got = tb.extract(s_t.to(dev), tau_t.to(dev), k, m_t.to(dev), BLOCK_N)
        ref = tb.extract_plain(s_t, m_t, tau_t, k, BLOCK_N)
        require(torch.equal(got[0].cpu().view(torch.int32),
                            ref[0].view(torch.int32))
                and torch.equal(got[1].cpu(), ref[1]),
                f"extract k={k}, survivors {founds}: kernel != plain")
        errs["extract"] = max(errs.get("extract", 0.0),
                              max_err(got[0], ref[0]))


def merge_rows(rng, k: int, w: int = 2 * MERGE_CAP + 37):
    """(vals (R, w), ids (R, w), tau (R,), founds): rows built to break
    pruned_merge's selection, w not a multiple of its block. Row r <
    len(founds) holds exactly founds[r] survivors (>= tau = 1.0, value ties
    across distinct ids) among values below tau and -inf: 0, 1, 31, 32, 33
    (one warp and past it), k - 1, k, k + 1, F and F + 1 (F = MERGE_CAP,
    the most it ranks directly). Then, at tau = -inf: a row of repeated
    (value, id) pairs with fewer than F survivors and one with more, each
    repeating one pair in 20 lanes and holding (+0.0, 7) and (-0.0, 7) as
    one pair (the lowest lane's sign bit is written), (-0.0, 8) before
    (+0.0, 8), and (+0.0, 9) in lane 1 before (-0.0, 9) in lane 16 (a
    shuffle reduction that keeps its own lane on a tie picks lane 16); and
    a row with NaN candidates. The tests of pruned_merge use them too (the
    JAX parity tests the rows of k to F + 1 survivors)."""
    founds = sorted({0, 1, 31, 32, 33, k - 1, k, k + 1, MERGE_CAP,
                     MERGE_CAP + 1})
    rows = len(founds) + 3
    vals = rng.uniform(-3.0, 0.99, (rows, w)).astype(np.float32)
    ids = np.stack([rng.permutation(w) for _ in range(rows)]).astype(np.int32)
    tau = np.ones(rows, np.float32)
    for r, f in enumerate(founds):
        cols = rng.choice(w, f + 40, replace=False)
        vals[r, cols[:f]] = 1.0 + np.round(rng.random(f) * 4) / 4
        vals[r, cols[f:]] = NEG_INF
    for r, n_fin in ((len(founds), MERGE_CAP - 20), (len(founds) + 1, w)):
        tau[r] = NEG_INF
        vals[r] = -np.round(rng.random(w) * 8) / 4 - 0.25   # below +-0.0
        vals[r, n_fin:] = NEG_INF
        vals[r, 10:30], ids[r, 10:30] = 0.5, 3           # one pair, 20 lanes
        vals[r, [2, 40, 90]], ids[r, [2, 40, 90]] = [0.0, -0.0, 0.0], 7
        vals[r, [4, 60]], ids[r, [4, 60]] = [-0.0, 0.0], 8
        vals[r, [1, 16]], ids[r, [1, 16]] = [0.0, -0.0], 9   # one warp
    r = len(founds) + 2
    tau[r] = NEG_INF
    vals[r, rng.random(w) < 0.3] = np.nan
    return vals, ids, tau, founds


def chunk_rows(rng, k: int, chunk_w: int, n: int = 40_981):
    """(vals (4, k + min(k, chunk_w)), ids): the chunked evaluation's merge
    input, the running best (sorted, empty slots (-inf, n + 1)) beside one
    chunk's sorted top-k (ids offset, empty slots (-inf, SENTINEL)). Row 0
    is the first chunk (the running best empty), row 1 a later one, row 2
    ties across the halves, row 3 a chunk with fewer than k finite items."""
    kc = min(k, chunk_w)
    best_v = -np.sort(-rng.standard_normal((4, k)).astype(np.float32), 1)
    best_i = np.stack([rng.choice(n // 2, k, replace=False)
                       for _ in range(4)]).astype(np.int32)
    chunk_v = -np.sort(-rng.standard_normal((4, kc)).astype(np.float32), 1)
    chunk_i = (n // 2 + np.stack([rng.choice(chunk_w, kc, replace=False)
                                  for _ in range(4)])).astype(np.int32)
    best_v[0], best_i[0] = NEG_INF, n + 1
    best_v[2] = np.round(best_v[2])
    chunk_v[2] = np.round(chunk_v[2])
    chunk_v[3, kc // 2:], chunk_i[3, kc // 2:] = NEG_INF, tb.SENTINEL
    return (np.concatenate([best_v, chunk_v], 1),
            np.concatenate([best_i, chunk_i], 1))


def merge_adversarial(dev, errs: dict) -> None:
    """pruned_merge on merge_rows (k = 10 and 50) and vmem_topk on the
    chunked merge (k = 50 beside a chunk of 8,192 and of the last 21 items,
    k = 10): values (as int32, so signed zeros count) and ids equal to
    pruned_merge_plain's."""
    rng = np.random.default_rng(SEED + 7)
    cases = []
    for k in (K, K_EVAL):
        vals, ids, tau, founds = merge_rows(rng, k)
        got = ((torch.from_numpy(vals) >= torch.from_numpy(tau)[:, None])
               & (torch.from_numpy(vals) != NEG_INF)).sum(1)
        require(got[:len(founds)].tolist() == founds,
                f"merge rows: {got.tolist()} survivors")
        cases.append((f"k={k}, survivors {founds}", vals, ids, tau, k))
    for k, chunk_w in ((K_EVAL, CHUNK), (K_EVAL, 21), (K, CHUNK)):
        vals, ids = chunk_rows(rng, k, chunk_w)
        cases.append((f"chunked merge k={k}, chunk {chunk_w}", vals, ids,
                      np.full(4, NEG_INF, np.float32), k))
    for what, vals, ids, tau, k in cases:
        cpu = [torch.from_numpy(x) for x in (vals, ids, tau)]
        got = tb.pruned_merge(*(x.to(dev) for x in cpu[:2]), k,
                              cpu[2].to(dev))
        ref = tb.pruned_merge_plain(cpu[0], cpu[1], k, cpu[2])
        require(torch.equal(got[0].cpu().view(torch.int32),
                            ref[0].view(torch.int32))
                and torch.equal(got[1].cpu(), ref[1]),
                f"pruned_merge {what}: kernel != plain")
        errs["pruned_merge"] = max(errs.get("pruned_merge", 0.0),
                                   max_err(got[0], ref[0]))


def rank_rows(rng, w: int, t_count: int):
    """(vals (4, w), ids, s_t (4, t_count), t_ids): candidates and probes
    built to break rank_count's packed key and its segments of equal
    keys. Candidate values from +-0.0, +-inf, NaN, +-1e-40, +-FLT_MAX, 0.5,
    -0.5 and 1.0; ids random in [-40, 40] (negative ids, duplicates), the
    -inf ones with the sentinel id where extract puts it; row 2 repeats
    each pair up to 40 times in a row (+-0.0 of one id one key), row 3 has
    extract's empty slots in every block of 50. Probes: candidate pairs as
    they are, the same pairs with the sign of a zero flipped, NaN, -inf
    with ids either side of the sentinel, and random values and ids."""
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                     3.4028235e38, -3.4028235e38, 0.5, -0.5, 1.0], np.float32)
    vals = pool[rng.integers(0, len(pool), (4, w))]
    ids = rng.integers(-40, 41, (4, w)).astype(np.int32)
    ids[:, : w // 3] = np.where(vals[:, : w // 3] == NEG_INF, tb.SENTINEL,
                                ids[:, : w // 3])
    # row 2: each pair repeated 1-40 times in a row (a zero's sign flipped
    # on every other copy); row 3: blocks of 50 whose last 40 slots are
    # extract's empty (-inf, SENTINEL)
    reps = rng.integers(1, 41, w)
    at = np.repeat(np.arange(w), reps)[:w]
    vals[2], ids[2] = vals[2, at], ids[2, at]
    vals[2, 1::2] = np.where(vals[2, 1::2] == 0.0, -vals[2, 1::2],
                             vals[2, 1::2])
    empty = np.arange(w) % 50 >= 10
    vals[3, empty], ids[3, empty] = NEG_INF, tb.SENTINEL
    pick = rng.integers(0, w, (4, t_count))
    s_t = np.take_along_axis(vals, pick, 1)
    t_ids = np.take_along_axis(ids, pick, 1)
    kind = rng.integers(0, 5, (4, t_count))
    s_t = np.where((kind == 1) & (s_t == 0.0), -s_t, s_t)
    s_t = np.where(kind == 2, np.nan, s_t).astype(np.float32)
    s_t = np.where(kind == 3, NEG_INF, s_t).astype(np.float32)
    t_ids = np.where(kind == 3,
                     tb.SENTINEL + rng.integers(-1, 2, (4, t_count)), t_ids)
    rand = kind == 4
    s_t[rand] = pool[rng.integers(0, len(pool), int(rand.sum()))]
    t_ids[rand] = rng.integers(-2 ** 31, 2 ** 31 - 1, int(rand.sum()))
    return vals, ids, s_t, t_ids.astype(np.int32)


def rank_adversarial(dev, errs: dict) -> None:
    """rank_count on rank_rows at w = 37 and 2,349 (no multiple of any
    tile, two key tiles) and T in {1, 129, 416}: equal to
    rank_count_plain."""
    rng = np.random.default_rng(SEED + 8)
    for w in (37, 2349):
        for t_count in (1, 129, 416):
            cpu = [torch.from_numpy(x) for x in rank_rows(rng, w, t_count)]
            got = tb.rank_count(*(x.to(dev) for x in cpu))
            require(torch.equal(got.cpu(), tb.rank_count_plain(*cpu)),
                    f"rank_count W={w} T={t_count}: kernel != plain")


def rank_case(rng, n: int, b: int, width: int, t_count: int, k: int):
    """Scores, mask table and probes for the rank kernels: a tie storm, a
    row of ties, a row with fewer than k finite items, one with fewer than
    k unmasked items (when the table is as wide as the catalog); probes
    that are masked, out of range, duplicated or scored -inf, and probes
    from the row's masked top-2k so that ranks below k occur."""
    s = rng.standard_normal((b, n)).astype(np.float32)
    s[0] = 0.0
    s[1] = np.round(s[1])
    s[2, k // 2:] = NEG_INF
    mask = rng.integers(0, n, (b, width)).astype(np.int32)
    mask[:, -4:] = n                                   # padding
    if width >= n:
        mask[3] = np.arange(width) % n                 # row 3 fully masked
        mask[3, : k // 2] = n
    probes = rng.integers(-3, n + 3, (b, max(t_count, 64))).astype(np.int32)
    masked = metrics.mask_items(torch.from_numpy(s), torch.from_numpy(mask))
    probes[:, :20] = torch.sort(masked, dim=1, descending=True,
                                stable=True).indices[:, :20].numpy()
    probes[:, 20:25] = mask[:, :5]                     # masked
    probes[:, 25:30] = probes[:, 30:31]                # duplicated
    probes[2, 30:35] = np.arange(k, k + 5)             # scored -inf
    return s, mask, probes[:, :t_count]


def check_ranks(what: str, scores, mask, probes, k: int,
                errs: dict) -> torch.Tensor:
    """direct_rank and, where the catalog takes the candidate route,
    rank_count and masked_topk_ranks, on the card against their plain
    versions on CPU copies; below k the two routes agree. Returns the
    plain ranks."""
    s_cpu, p_cpu = scores.cpu(), probes.cpu()
    m_cpu = None if mask is None else mask.cpu()
    ref = tb.direct_rank_plain(s_cpu, m_cpu, p_cpu, k)
    expect_equal(f"{what} direct_rank", [tb.direct_rank(scores, probes, k,
                                                        mask)],
                 [ref], errs, "direct_rank")
    if not metrics.use_blockwise_ranks(scores.shape[1], k):
        return ref
    cv, ci, _ = tb.blockwise_candidates(scores, k, BLOCK_N, mask)
    st = scores.gather(1, probes.clamp(0, scores.shape[1] - 1).long())
    expect_equal(f"{what} rank_count", [tb.rank_count(cv, ci, st, probes)],
                 [tb.rank_count_plain(cv.cpu(), ci.cpu(), st.cpu(), p_cpu)],
                 errs, "rank_count")
    ranks = tb.masked_topk_ranks(scores, k, probes, mask)
    expect_equal(f"{what} masked_topk_ranks", [ranks],
                 [tb.masked_topk_ranks(s_cpu, k, p_cpu, m_cpu)], errs,
                 "rank_count")
    require(torch.equal(ranks.cpu().clamp(max=k), ref.clamp(max=k)),
            f"{what}: the two rank routes disagree below k")
    return ref


def adversarial_ranks(dev, errs: dict) -> None:
    rng = np.random.default_rng(SEED + 2)
    for n, width in ((ITEMS, 300), (ML_ITEMS, ML_ITEMS)):
        s, mask, probes = rank_case(rng, n, 16, width, 424, K_EVAL)
        for t_count in (1, 130, 424):
            ref = check_ranks(f"adversarial N={n} T={t_count}",
                              *(torch.from_numpy(x).to(dev)
                                for x in (s, mask, probes[:, :t_count])),
                              K_EVAL, errs)
            require(int((ref < K_EVAL).sum()) > 0
                    and (t_count == 1 or int((ref == K_EVAL).sum()) > 0),
                    f"N={n} T={t_count}: hits and misses both occur")
        check_ranks(f"adversarial N={n} no mask",
                    torch.from_numpy(s).to(dev), None,
                    torch.from_numpy(probes).to(dev), K_EVAL, errs)
    # direct_rank's route (N // 128 < 2k) on a NaN row, a NaN at every 7th
    # id and probes on and beside them (a NaN never counts above a probe, a
    # probe scored NaN gets k, as in JAX), and a row of +0.0 and -0.0 at
    # alternate ids (they tie: the lower id first)
    s, mask, probes = rank_case(rng, ML_ITEMS, 16, 300, 424, K_EVAL)
    s[4, 1::7] = np.nan
    probes[4, :8] = (1, 2, 7, 8, 9, 15, 16, 100)
    s[5] = np.where(np.arange(ML_ITEMS) % 2, 0.0, -0.0)
    probes[5, :8] = (0, 1, 2, 3, 40, 41, 1000, 1001)
    ref = check_ranks("adversarial NaN and signed-zero rows",
                      *(torch.from_numpy(x).to(dev) for x in (s, mask,
                                                              probes)),
                      K_EVAL, errs)
    require(int((ref[4] < K_EVAL).sum()) > 0 and int((ref[5] < K_EVAL).sum())
            > 0, "the NaN and signed-zero rows hold hits")
    rank_adversarial(dev, errs)


def check_ordered_sums(dev, items: np.ndarray, errs: dict) -> None:
    """The train path's ordered sums on the card against their plain
    versions on CPU copies (per row within 1e-5 * sum|g| of float64), each
    called twice with bit-equal results: ordered_row_sum (index_put_ or
    sorted pieces on the card, index_add_ on the CPU) at GRU4RecPlus's
    2,176, SASRec's 6,400 and SRGNN's 51,200 gathered rows of the (N, 64)
    table and of the (N,) bias, ids drawn
    from ``items`` (the training pairs' items: their popularity, hubs of
    hundreds of repeats); and kernel #11 on a fixed gather set, the
    training pairs' items as a FixedIndex (fixed_index), by fixed_sum and
    by fixed_gather's gradient, at D = 1 and 64 (check_segsum's rule; three
    launches bit-equal)."""
    rng = np.random.default_rng(SEED + 2)
    for k in (2_176, 6_400, 51_200):
        ids = torch.as_tensor(rng.choice(items, k), device=dev)
        for width in ((DIM,), ()):
            g = torch.randn((k, *width), device=dev,
                            generator=torch.Generator(dev).manual_seed(k))
            got = scatter.ordered_row_sum(ids, g, ITEMS)
            again = scatter.ordered_row_sum(ids, g, ITEMS)
            ref = scatter.ordered_row_sum(ids.cpu(), g.cpu().double(), ITEMS)
            bound = 1e-5 * scatter.ordered_row_sum(
                ids.cpu(), g.cpu().double().abs(), ITEMS) + 1e-30
            err = (got.cpu().double() - ref).abs()
            require(bool((err <= bound).all()) and same_bits(again, got),
                    f"ordered_row_sum K={k} width {width}: error "
                    f"{float((err / bound).max())} x the bound, twice equal "
                    f"{same_bits(again, got)}")
            print(f"ordered_row_sum of {k} rows (width {width or 1}, "
                  f"largest run {int(torch.bincount(ids).max())}) == plain "
                  f"within {float((err / bound).max())} of the bound, two "
                  f"calls bit-equal", flush=True)
    fixed = scatter.fixed_index(items, ITEMS, dev)
    for d in (1, DIM):
        x = torch.randn((len(items), d), device=dev,
                        generator=torch.Generator(dev).manual_seed(d))
        share = check_segsum(fixed.seg, x, None, "f32", errs)
        check_repeat(fixed.seg, x, None, "f32")
        table = torch.zeros((ITEMS, d), device=dev, requires_grad=True)
        scatter.fixed_gather(table, fixed).backward(x)
        summed = scatter.fixed_sum(x, fixed)
        require(same_bits(table.grad, summed),
                "fixed_gather's gradient is not fixed_sum's")
        print(f"segsum on the fixed gather set of {len(items)} training "
              f"pairs' items into {ITEMS} rows ({fixed.seg.seg_dst.shape[0]}"
              f" segments, {fixed.seg.merge_row.shape[0]} rows merged), D="
              f"{d}: within {share} of the bound, three launches bit-equal, "
              f"fixed_gather's gradient == fixed_sum", flush=True)


def check_segsum(seg, x, mask, msg: str, errs: dict):
    """segsum (its merge pass included) on the card against segsum_plain in
    float64 on CPU copies: per row |kernel - ref| <= 1e-5 * sum|msg| +
    1e-30, rows without a kept edge exactly 0, the output finite, every
    arrival counter back at 0. Returns the kernel's and the f32 plain
    version's largest error as a share of the bound."""
    seg_cpu = seg.to("cpu")
    x_cpu = x.cpu()
    m_cpu = None if mask is None else mask.cpu()
    dtype = MSG[msg]
    got = ss.segsum(seg, x, mask, dtype).cpu().double()
    ref = ss.segsum_plain(seg_cpu, x_cpu.double(), m_cpu, dtype)
    scale = ss.segsum_plain(seg_cpu._replace(weight=seg_cpu.weight.abs()),
                            x_cpu.abs().double(), m_cpu, dtype)
    bound = 1e-5 * scale + 1e-30
    err = (got - ref).abs()
    plain = (ss.segsum_plain(seg_cpu, x_cpu, m_cpu, dtype).double()
             - ref).abs()
    require(bool(torch.isfinite(got).all()), "segsum: non-finite output")
    require(bool((err <= bound).all()),
            f"segsum {msg}: error {float((err / bound).max())} x the bound")
    require(bool((got[scale == 0] == 0).all()),
            "segsum: a row without a kept edge is not 0")
    require(not bool(seg.merge_count.any()), "segsum left a counter set")
    if not err.numel():
        return 0.0, 0.0
    errs["segsum"] = max(errs.get("segsum", 0.0), float(err.max()))
    return float((err / bound).max()), float((plain / bound).max())


def check_repeat(seg, x, mask, msg: str, calls: int = 3) -> None:
    """``calls`` launches in a row on one Segments: each output's bits equal
    the first's, and the arrival counters are 0 after each (the merge pass
    resets them)."""
    first = ss.segsum(seg, x, mask, MSG[msg])
    for i in range(1, calls):
        again = ss.segsum(seg, x, mask, MSG[msg])
        torch.cuda.synchronize()
        require(torch.equal(again.view(torch.int32), first.view(torch.int32))
                and not bool(seg.merge_count.any()),
                f"segsum {msg}: launch {i + 1} on one Segments differs")


def segsum_adversarial(dev, errs: dict) -> None:
    """The kernel on graphs built to break it, D = 8, 64 and 128, both
    message types, with and without an edge mask."""
    rng = np.random.default_rng(SEED + 3)
    hub = 20 * ss.SEGMENT_EDGES + 3
    # 40 rows of 2 to 4 segments side by side: many merged rows in a block
    multi = np.repeat(np.arange(40), rng.integers(129, 4 * 128 + 1, 40))
    cases = {
        # one destination of >= 20 segments
        "hub": (rng.integers(0, 900, hub), np.zeros(hub, np.int64),
                rng.random(hub), 40, 900),
        "merged rows in one block": (rng.integers(0, 900, len(multi)), multi,
                                     rng.random(len(multi)), 60, 900),
        # 380 of 400 rows without edges
        "isolated rows": (rng.integers(0, 400, 300),
                          rng.integers(0, 20, 300) * 19, rng.random(300),
                          400, 400),
        "empty graph": (np.array([], np.int64), np.array([], np.int64),
                        np.array([]), 33, 33),
        "rectangular": (rng.integers(0, 5000, 40_000),
                        rng.integers(0, 1500, 40_000), rng.random(40_000),
                        1500, 5000),
        "inf/NaN sources": (rng.integers(0, 600, 9000),
                            rng.integers(0, 600, 9000), rng.random(9000),
                            600, 600),
    }
    for name, (src, dst, w, n, n_src) in cases.items():
        g = graph_from_coo(src, dst, w, n, num_src_nodes=n_src, device=dev)
        mask = torch.from_numpy((rng.random(len(src)) < 0.35)
                                .astype(np.float32) / 0.35).to(dev)
        shares = []
        for d in (8, 64, 128):
            x = torch.randn((n_src, d), device=dev)
            masks = (None, mask)
            if name == "inf/NaN sources":   # their edges all dropped
                bad = torch.tensor([5, 99, 300], device=dev)
                x[bad, 0::2] = float("inf")
                x[bad, 1::2] = float("nan")
                mask[g.fwd.orig[torch.isin(g.fwd.src, bad.int())].long()] = 0
                masks = (mask,)
            for msg in MSG:
                for m in masks:
                    shares.append(check_segsum(g.fwd, x, m, msg, errs))
                    check_repeat(g.fwd, x, m, msg)
                    if name == "rectangular":
                        shares.append(check_segsum(
                            g.bwd, torch.randn((n, d), device=dev), m, msg,
                            errs))
        print(f"  segsum {name} ({len(src)} edges, largest in-degree "
              f"{g.fwd.max_degree}): worst error {max(a for a, _ in shares)}"
              f" of the bound, f32 plain {max(b for _, b in shares)}",
              flush=True)


def check_served(server, u, ids, vals, seen) -> torch.Tensor:
    """A served answer equals the plain top-k of the model's scores for
    the same users (blockwise_topk and a full sort on CPU copies) and holds
    no seen item; returns the scores' CPU copy."""
    require(ids.shape == vals.shape == (len(u), K)
            and np.isfinite(vals).all(), "finite (B, k) answers")
    s_cpu = server.model.predict(u).cpu()
    m_cpu = server._seen[torch.as_tensor(u, device=server.device)].cpu()
    ref_v, ref_i = tb.blockwise_topk(s_cpu, K, mask_table=m_cpu)
    np.testing.assert_array_equal(ids, ref_i.numpy())
    np.testing.assert_array_equal(vals, ref_v.numpy())
    _, sort_i = metrics.topk_scores_and_indices(s_cpu, K, m_cpu)
    np.testing.assert_array_equal(ids, sort_i.numpy())
    for user, row in zip(u, ids):
        require(not np.isin(row, seen.get(int(user), [])).any(),
                f"user {user} got a seen item")
    return s_cpu


def _host_call_times():
    """``experiments/host_call_times.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "host_call_times", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "experiments", "host_call_times.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# a fresh process: load the exported tail, run it on saved inputs, save
# its answer, print its launches and whether JAX or the JAX package loaded
FRESH_LOAD = """
import json, sys
import torch
import skrx_torch
from skrx_torch.ops.kernels import runtime
program = torch.export.load(sys.argv[1])
scores, seen = (t.to("cuda") for t in torch.load(sys.argv[2]))
runtime.reset_launches()
ids, vals = program.module()(scores, seen)
torch.cuda.synchronize()
launches = dict(runtime.LAUNCHES)
torch.save((ids.cpu(), vals.cpu()), sys.argv[3])
print(json.dumps({"launches": launches, "jax": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "skrx"))}))
"""


def check_export(server, rng, seen: dict, work: str, card: str):
    """Phase 3's export (the module docstring). Returns the launches of
    the loaded program's run and a function that waits for the fresh
    process and checks its answer: the process starts here and runs beside
    the next phases (killed at exit if the run fails first)."""
    blob, sec = timed(lambda: server.export_program(EXPORT_B))
    program = torch.export.load(io.BytesIO(blob))
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("skrx.")]
    print(f"export_program({EXPORT_B}): {len(blob)} bytes in {sec} s; skrx "
          f"operators in its graph: {ops}  [{card}]", flush=True)
    require(sorted({o.split(".")[1] for o in ops}) == sorted(SERVING),
            "the exported graph must call the four tail operators")
    u = rng.choice(USERS, EXPORT_B, replace=False)
    u_t = torch.as_tensor(u, device=server.device)
    scores = server.model.predict(u_t).to(torch.float32)
    seen_rows = server._seen[u_t]
    run = program.module()
    (ids, vals), launches = counted(lambda: run(scores, seen_rows))
    print(f"launches while the loaded program ran: {launches}")
    for kname in SERVING:
        require(launches[kname] >= 1,
                f"{kname} never launched by the loaded program")
    ids, vals = ids.cpu().numpy(), vals.cpu().numpy()
    r_ids, r_vals = server.recommend(u)
    require(np.array_equal(ids, r_ids)
            and np.array_equal(vals.view(np.int32), r_vals.view(np.int32)),
            "the loaded program's answer != recommend's")
    check_served(server, u, ids, vals, seen)
    os.makedirs(work, exist_ok=True)
    paths = [os.path.join(work, f) for f in ("rank_tail.pt2", "in.pt",
                                             "out.pt")]
    with open(paths[0], "wb") as f:
        f.write(blob)
    torch.save((scores.cpu(), seen_rows.cpu()), paths[1])
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", FRESH_LOAD, *paths],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=root, env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    print("exported tail == recommend == plain top-k; a fresh process "
          "loads it beside the next phases", flush=True)

    def finish() -> None:
        stdout, stderr = proc.communicate(timeout=600)
        require(proc.returncode == 0,
                f"the fresh process failed: {stderr[-3000:]}")
        rec = json.loads(stdout.strip().splitlines()[-1])
        f_ids, f_vals = torch.load(paths[2])
        print(f"fresh process (done {time.perf_counter() - t0} s after its "
              f"start): launches {rec['launches']}, JAX modules "
              f"{rec['jax']}")
        require(rec["jax"] == [], "the fresh process imported JAX or skrx")
        for kname in SERVING:
            require(rec["launches"][kname] >= 1,
                    f"{kname} never launched in the fresh process")
        require(np.array_equal(f_ids.numpy(), ids)
                and np.array_equal(f_vals.numpy().view(np.int32),
                                   vals.view(np.int32)),
                "the fresh process's answer != the loaded program's")
        print("the exported tail loaded in a fresh process == the loaded "
              "program", flush=True)
    return launches, finish


def cpu_packed(packed: dt.PackedItems) -> dt.PackedItems:
    return packed._replace(table=packed.table.cpu(), bias=packed.bias.cpu())


def check_fused(what: str, uv, packed, mask, k: int, errs: dict):
    """dot_submax and dot_extract on the card against their plain versions
    on CPU copies of the same inputs, bit for bit; tau as the composition
    takes it. Returns the card's (tau, cand_vals, cand_ids)."""
    pc, uv_c = cpu_packed(packed), uv.cpu()
    m_c = None if mask is None else mask.cpu()
    scores = dt.dot_scores_plain(uv_c, pc)   # what both plain versions score
    bm = dt.dot_submax(uv, packed, mask)
    expect_equal(f"{what} dot_submax", [bm],
                 [tb.submax_plain(scores, m_c, pc.block_n)], errs,
                 "dot_submax")
    if bm.shape[1] >= k:
        bmf = tb.fold_submaxes(bm, k).contiguous()
        tau = tb.kth_largest(bmf, k)
        expect_equal(f"{what} tau bits", [tau.view(torch.int32)],
                     [tb.kth_largest_plain(bmf.cpu(), k).view(torch.int32)],
                     errs, "kth_largest")
    else:
        tau = torch.full((uv.shape[0],), NEG_INF, device=uv.device)
    cv, ci = dt.dot_extract(uv, packed, tau, k, mask)
    expect_equal(f"{what} dot_extract", [cv, ci],
                 tb.extract_plain(scores, m_c, tau.cpu(), k, pc.block_n),
                 errs, "dot_extract")
    return tau, cv, ci


def check_lookup(what: str, cv, ci, probes, errs: dict) -> None:
    """rank_lookup_count on the card against its plain version on CPU
    copies: ranks and found equal."""
    expect_equal(f"{what} rank_lookup_count",
                 tb.rank_lookup_count(cv, ci, probes),
                 tb.rank_lookup_count_plain(cv.cpu(), ci.cpu(), probes.cpu()),
                 errs, "rank_lookup_count")


def lookup_probes(rng, ids, mask, n: int, t_count: int) -> np.ndarray:
    """Probes for rank_lookup_count: the row's candidate ids (found, some
    of rank < k), masked ids, padding (n), out of range, duplicated and
    random ids."""
    p = rng.integers(-3, n + 3, (ids.shape[0], max(t_count, 40)))
    p[:, :12] = ids[:, :12]
    if mask is not None:
        p[:, 12:17] = mask[:, :5]                      # masked
    p[:, 17], p[:, 18], p[:, 19] = n, -1, n + 5        # padding, out of range
    p[:, 20:26] = p[:, 1:2]                            # duplicated
    return p[:, :t_count].astype(np.int32)


def lookup_rows(rng, w: int, t_count: int):
    """(vals (4, w), ids, t_ids (4, t_count)): candidates and probe ids
    built to break rank_lookup_count's lookup. Values from rank_rows' pool
    (+-0.0, +-inf, NaN, +-1e-40, +-FLT_MAX, 0.5, -0.5, 1.0); ids of [-40,
    40], so that an id repeats in a row with NaN, -inf and finite copies;
    row 1 in blocks of 50 whose last 40 slots are extract's empty (-inf,
    SENTINEL) (fused evaluation's candidates); row 2 with no -inf and no
    NaN lane (the lookup's list as long as the row, every probe's score the
    max of its finite copies); row 3 ids of [0, w // 2), about two copies
    an id (a NaN beside a finite copy). Probes: ids of the row, the
    sentinel and its neighbours, -1, +-2**31 extremes and ids of [-42, 42]
    (some among no candidate), duplicated."""
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                     3.4028235e38, -3.4028235e38, 0.5, -0.5, 1.0], np.float32)
    vals = pool[rng.integers(0, len(pool), (4, w))]
    ids = rng.integers(-40, 41, (4, w)).astype(np.int32)
    empty = np.arange(w) % 50 >= 10
    vals[1, empty], ids[1, empty] = NEG_INF, tb.SENTINEL
    bad = ~np.isfinite(vals[2]) & (vals[2] != np.inf)
    vals[2, bad] = rng.standard_normal(int(bad.sum()))
    ids[3] = rng.integers(0, max(w // 2, 1), w)
    pick = rng.integers(0, w, (4, t_count))
    t_ids = np.take_along_axis(ids, pick, 1)
    kind = rng.integers(0, 6, (4, t_count))
    t_ids = np.where(kind == 1, tb.SENTINEL + rng.integers(-1, 2, (4, t_count)),
                     t_ids)
    t_ids = np.where(kind == 2, rng.choice([-1, -2 ** 31, 2 ** 31 - 1],
                                           (4, t_count)), t_ids)
    t_ids = np.where(kind == 3, rng.integers(-42, 43, (4, t_count)), t_ids)
    t_ids[:, 1::7] = t_ids[:, :1]                      # duplicated
    return vals, ids, t_ids.astype(np.int32)


def lookup_adversarial(dev, errs: dict) -> None:
    """rank_lookup_count on lookup_rows at W in {37, 550, 2,049, 5,000}
    (one tile, then two and three: the row read twice) and T in {1, 129,
    416}: ranks and found equal to rank_lookup_count_plain's."""
    rng = np.random.default_rng(SEED + 10)
    for w in (37, 550, 2049, 5000):
        for t_count in (1, 129, 416):
            cpu = [torch.from_numpy(x) for x in lookup_rows(rng, w, t_count)]
            check_lookup(f"lookup rows W={w} T={t_count}",
                         *(x.to(dev) for x in cpu), errs)


def fused_adversarial(dev, items, errs: dict) -> None:
    """The fused kernels on inputs built to break them."""
    rng = np.random.default_rng(SEED + 4)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    # duplicated item rows, and zero user vectors over a constant bias:
    # every score of a row equal, across whole 4,096-column blocks
    dup = items.clone()
    dup[ITEMS // 2: ITEMS // 2 + 4096] = dup[:4096]
    uv = torch.randn((64, DIM), device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED))
    uv[::2] = 0.0
    mask = rng.integers(0, ITEMS, (64, 40)).astype(np.int32)
    mask[:, -5:] = ITEMS
    for bias in (torch.full((ITEMS,), 0.5, device=dev), None):
        packed = dt.pack_items(dup, bias)
        for k in (K, K_EVAL):
            _, cv, ci = check_fused(f"tie storm k={k}", uv, packed, t(mask), k,
                                    errs)
            check_lookup(f"tie storm k={k}", cv, ci, t(lookup_probes(
                rng, ci.cpu().numpy(), mask, ITEMS, 300)), errs)
    # ties across the slices that a cluster splits a column block into: at
    # B=64 eight CTAs score 512 columns each, and each column c of a block
    # repeats at c + 512, c + 1024, ... so that every score of a row ties
    # with one in each other slice; found stays under the list's cap
    tied = items.clone()
    for blk in range(0, ITEMS - BLOCK_N, BLOCK_N):
        tied[blk + 512: blk + BLOCK_N] = tied[blk: blk + 512].repeat(7, 1)
    packed = dt.pack_items(tied, torch.full((ITEMS,), 0.25, device=dev))
    uv = torch.randn((64, DIM), device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED + 1))
    for k in (K, K_EVAL):
        _, cv, ci = check_fused(f"slice ties k={k}", uv, packed, t(mask), k,
                                errs)
        require(bool((cv[:, 1] == cv[:, 0]).all()),
                "slice ties: the two best of a block tie")
    # fully masked rows and rows with fewer than k unmasked items, N not a
    # multiple of the block
    n = 8192 + 1000
    packed = dt.pack_items(torch.randn((n, DIM), device=dev), None)
    uv = torch.randn((8, DIM), device=dev)
    mask = np.full((8, n), n, np.int32)
    mask[0] = np.arange(n)
    mask[1, : n - 4] = rng.permutation(n)[: n - 4]
    mask[2, :5] = [-1, n + 3, 7, 7, n - 1]
    for k in (K, K_EVAL):
        _, cv, ci = check_fused(f"masked rows k={k}", uv, packed, t(mask), k,
                                errs)
        for t_count in (1, 130):
            check_lookup(f"masked rows k={k} T={t_count}", cv, ci,
                         t(lookup_probes(rng, ci.cpu().numpy(), mask, n,
                                         t_count)), errs)
    # other widths, with and without a bias; a small catalog (n_sub < k:
    # tau = -inf)
    for d, n, bias in ((8, 5000, True), (60, 9000, False), (128, 4100, True),
                       (512, 6000, False), (16, 300, True)):
        b = 33
        items_d = torch.randn((n, d), device=dev)
        packed = dt.pack_items(items_d, torch.randn(n, device=dev)
                               if bias else None)
        uv = torch.randn((b, d), device=dev)
        mask = rng.integers(-2, n + 2, (b, 50)).astype(np.int32)
        k = 200 if n == 300 else K_EVAL
        _, cv, ci = check_fused(f"d={d} N={n}", uv, packed, t(mask), k, errs)
        check_lookup(f"d={d} N={n}", cv, ci, t(lookup_probes(
            rng, ci.cpu().numpy(), mask, n, 300)), errs)
    submax_adversarial(dev, items, errs)
    lookup_adversarial(dev, errs)
    try:
        dt.pack_items(torch.zeros((10, dt.MAX_DIM + 1), device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("d > 512 must be refused")


def submax_adversarial(dev, items, errs: dict) -> None:
    """dot_submax where a 4,096-column block is split over a cluster of 8
    CTAs (B = 1, 7 and 33 over the Gowalla catalog), bit for bit against
    its plain version on CPU copies (the int32 views equal, NaN by isnan):
    item columns repeated every 512 (equal group maxima in every CTA's
    slice), mask ids in every slice of every block, a fully masked row, a
    zero user vector over a bias of +-0.0 (zero maxima are +0.0), a NaN bias
    on a few items (NaN maxima); then d in {8, 60, 128, 512} on smaller
    catalogs, N not a multiple of the block."""
    rng = np.random.default_rng(SEED + 6)
    tied = items.clone()
    for blk in range(0, ITEMS - BLOCK_N, BLOCK_N):
        tied[blk + 512: blk + BLOCK_N] = tied[blk: blk + 512].repeat(7, 1)
    zeros = torch.from_numpy(np.where(rng.random(ITEMS) < 0.5, -0.0, 0.0)
                             .astype(np.float32)).to(dev)
    # a NaN bias on a few items: their scores are NaN in every row, so
    # their groups' maxima are NaN, as jnp.maximum folds them
    nan_bias = torch.from_numpy(np.where(rng.random(ITEMS) < 0.002, np.nan,
                                         rng.standard_normal(ITEMS))
                                .astype(np.float32)).to(dev)
    cases = [(dt.pack_items(tied, zeros), DIM),
             (dt.pack_items(items, nan_bias), DIM)]
    for d, n in ((8, 9000), (60, 9000), (128, 5000), (512, 6000)):
        cases.append((dt.pack_items(torch.randn((n, d), device=dev),
                                    torch.randn(n, device=dev)), d))
    for packed, d in cases:
        pc, n = cpu_packed(packed), packed.n
        n_sl = n // 512
        table = np.full((33, n), n, np.int32)
        for r in range(33):                   # 5 ids in each 512-column slice
            table[r, :5 * n_sl] = (np.arange(n_sl).repeat(5) * 512
                                   + rng.integers(0, 512, 5 * n_sl))
        table[1] = np.arange(n)               # fully masked
        for b in (1, 7, 33):
            uv = torch.randn((b, d), device=dev)
            uv[2:3] = 0.0                     # scores = bias
            for m in (torch.from_numpy(table[:b]).to(dev), None):
                got = dt.dot_submax(uv, packed, m).cpu()
                ref = tb.submax_plain(dt.dot_scores_plain(uv.cpu(), pc),
                                      None if m is None else m.cpu(),
                                      pc.block_n)
                require(same_bits(got, ref),
                        f"dot_submax B={b} d={d} N={n}: kernel != plain")
                errs["dot_submax"] = max(errs.get("dot_submax", 0.0),
                                         max_err(got, ref))


def peak_above(fn):
    """(result, peak device bytes allocated during fn() above what was
    allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def serve_measured(server, u):
    """(u, ids, scores, peak bytes) of server.recommend(u), called once
    before so that the packed item table is cached."""
    server.recommend(u)
    (ids, vals), peak = peak_above(lambda: server.recommend(u))
    return u, ids, vals, peak


def check_fused_served(server, u, ids, vals, peak, seen) -> int:
    """A fused answer equals dot_topk's plain version on CPU copies, holds
    no seen item, and is within 1e-5 (relative) of the score-matrix route,
    with ids equal where that route's values are separated by more; the
    call allocated less than one (B, N) f32 score matrix above what was
    allocated before it. Returns the rows whose ids differ from the
    score-matrix route."""
    require(peak < 4 * len(u) * ITEMS,
            f"fused recommend B={len(u)} allocated {peak} B")
    u_all, _ = server.model._chunk_embeddings()
    u_t = torch.as_tensor(u, device=server.device)
    ref_v, ref_i = dt.dot_topk_plain(
        u_all.detach()[u_t].cpu(), cpu_packed(server._packed_cache[2]), K,
        server._seen[u_t].cpu())
    np.testing.assert_array_equal(ids, ref_i.numpy())
    np.testing.assert_array_equal(vals, ref_v.numpy())
    for user, row in zip(u, ids):
        require(not np.isin(row, seen.get(int(user), [])).any(),
                f"user {user} got a seen item (fused)")
    # the score-matrix route's top k + 1, so that the last slot's gap to
    # the next item is known
    m_vals, m_ids = metrics.topk_scores_and_indices(
        server.model.predict(u_t), K + 1, mask_table=server._seen[u_t])
    m_vals, m_ids = m_vals.cpu().numpy(), m_ids.cpu().numpy()
    np.testing.assert_allclose(vals, m_vals[:, :K], rtol=1e-5, atol=1e-6)
    gap = np.abs(np.diff(m_vals, axis=1)) > 1e-5 * np.abs(m_vals[:, 1:])
    sep = gap[:, :K].copy()
    sep[:, 1:] &= gap[:, :K - 1]
    m_ids = m_ids[:, :K]
    require(sep.mean() > 0.9, f"separated slots {sep.mean()}")
    np.testing.assert_array_equal(ids[sep], m_ids[sep])
    print(f"  fused recommend B={len(u)}: == plain, {peak} B above the "
          f"allocated (one score matrix {4 * len(u) * ITEMS} B), "
          f"{int((ids != m_ids).any(1).sum())} rows with ids unlike the "
          f"score-matrix route", flush=True)
    return int((ids != m_ids).any(1).sum())


def select_ops(found: torch.Tensor, k: int) -> int:
    """Operations of extract's selection for these survivor counts per
    (row, block): found^2 compares where it ranks (found <= RANK_CAP), k
    rounds over the block's survivors where it does not."""
    found = found.long()
    rank = found <= RANK_CAP
    return int((found * found)[rank].sum()
               + (found.clamp(max=k) * found)[~rank].sum())


def rank_segments(vals: torch.Tensor, ids: torch.Tensor,
                  tile: int = 2048) -> torch.Tensor:
    """(B,) segments rank_count counts over in each row: maximal runs of
    equal adjacent packed keys (tb.rank_key) within each tile of ``tile``
    candidates (csrc/rank_counts.cu kKeyTile)."""
    key = tb.rank_key(vals, ids)
    new = torch.ones_like(key, dtype=torch.bool)
    new[:, 1:] = key[:, 1:] != key[:, :-1]
    new[:, ::tile] = True
    return new.sum(1)


def evaluate_as(m, mode: str, chunk_size: int = 0, users=None):
    """(MetricReport, host seconds) of m.evaluate(users) with the
    evaluator's eval_mode (and chunk size) set for the call."""
    ev = m.evaluator
    saved = ev.eval_mode, ev.chunk_size
    ev.eval_mode, ev.chunk_size = mode, chunk_size or ev.chunk_size
    try:
        return timed(lambda: m.evaluate(users))
    finally:
        ev.eval_mode, ev.chunk_size = saved


def metrics_card_vs_plain(m, u) -> float:
    """Largest difference between the per-user metrics of users ``u`` on
    the card and on the plain route (CPU copies of the same scores and
    tables); fails above 1e-6."""
    ev = m.evaluator
    tr, te, tl = ev._tables_for(u, m.num_items)
    tables = [torch.from_numpy(x) for x in (tr, te, np.maximum(tl, 1))]
    sc = m.predict(u)
    got = ev.per_user_metrics(sc, *(x.to(sc.device) for x in tables))
    ref = ev.per_user_metrics(sc.cpu(), *tables)
    err = float((got.cpu() - ref).abs().max())
    require(err <= 1e-6, f"{type(m).__name__}: per-user metrics card vs "
            f"plain differ by {err}")
    return err


def cpu_copy(state):
    """A nested training state with every tensor copied to the CPU."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    if isinstance(state, dict):
        return {k: cpu_copy(v) for k, v in state.items()}
    return state


def flat(state, prefix: str = "") -> dict:
    """The tensors of a nested training state by path."""
    if isinstance(state, torch.Tensor):
        return {prefix: state}
    out = {}
    if isinstance(state, dict):
        for key, value in state.items():
            out.update(flat(value, f"{prefix}/{key}"))
    return out


def bit_equal_states(a: dict, b: dict) -> bool:
    """The same tensors by path, equal bit for bit (-0.0 is not +0.0)."""
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].numpy().tobytes() == b[k].numpy().tobytes() for k in a)


def time_ms(fn, reps: int = None) -> float:
    """Median device time of fn() over reps launches (CUDA events; REPS
    when None)."""
    reps = reps or REPS
    for _ in range(5):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def launches_ms(fn, reps: int = 200) -> float:
    """Time per call of reps back-to-back calls of fn between two CUDA
    events (after warm-up): device time where the card is the bottleneck,
    the host's launch rate where the kernel is shorter than a launch."""
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(prof):
    """Kernel and copy events of a profile, user annotations left out (an
    optimizer's step range shows up as a device row)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]


def device_ms(fn, reps: int = None) -> float:
    """Device time per call of fn: the summed durations of the kernels and
    copies it launches (torch.profiler), over reps calls after warm-up.
    Unlike time_ms it
    leaves out the idle gaps while the host launches, which dominate a
    kernel of a few microseconds. A profile now and then records no device
    event at all; it is taken again, and after three empty ones the
    CUDA-event time of time_ms stands in (a line says so)."""
    from torch.profiler import ProfilerActivity, profile
    reps = reps or REPS
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in _device_events(prof))
        if total_us > 0:
            return total_us / reps / 1e3
    print("device_ms: three profiles recorded no device time; CUDA-event "
          "time instead", flush=True)
    return time_ms(fn, reps)


def busy_share(fn, reps: int = 20, warm: bool = True, top: int = 0):
    """Share of the host-clock time of ``reps`` calls of fn in which the
    card ran a kernel or a copy (sum of device event times from
    torch.profiler over the wall time; the profiler slows the host, so this
    is a lower bound), and the ``top`` device kernels by time as (name,
    ms, calls). The share is None when the profiler records no device
    time. The profiler's raw events are summed directly: building its
    per-op tables (``key_averages``) for a whole epoch takes minutes."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for name, ns in _raw_device_events(prof):
        total, calls = by_name.get(name, (0, 0))
        by_name[name] = (total + ns, calls + 1)
    busy_us = sum(total for total, _ in by_name.values()) / 1e3
    heads = [(name[:60], total / 1e6, calls) for name, (total, calls)
             in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]
    return (busy_us / wall_us if busy_us > 0 else None), heads


def _raw_device_events(prof):
    """(name, nanoseconds) of the kernels and copies a profile recorded,
    user annotations left out (as ``_device_events``)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if (e.device_type() == DeviceType.CUDA and not annotation
                and "#" not in e.name()):
            yield e.name(), e.duration_ns()


def epoch_window(m, steps: int = None):
    """A training epoch of model m cut to its first ``steps`` steps (its
    step count lowered for the call; GRU4Rec's walk by its step limit):
    the steady state of an epoch, at a fraction of a long epoch's time
    under the profiler (TRAIN_WINDOW steps when None)."""
    steps = steps or TRAIN_WINDOW
    if hasattr(m, "step_limit"):
        m.step_limit = steps
        try:
            return m._train_epoch(99)
        finally:
            m.step_limit = None
    owner = getattr(m, "pipeline", m)
    full = owner.num_batches
    owner.num_batches = min(steps, full)
    try:
        return m._train_epoch(99)
    finally:
        owner.num_batches = full


def timed(fn):
    """(result, host seconds) of fn() ended by a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(fn):
    """(result, launches per kernel) of fn(): the counts are set to 0 just
    before and read just after (a CPU rehearsal has nothing to sync)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    runtime.reset_launches()
    out = fn()
    sync()
    return out, dict(runtime.LAUNCHES)


def traced_routes(m) -> list:
    """Wrap model m's ``_train_epoch`` so that each epoch's
    ``pipeline.last_run`` (its route, replays, warm-up steps, capture
    seconds) is appended to the returned list."""
    runs = []
    inner = m._train_epoch

    def run(epoch):
        loss = inner(epoch)
        runs.append(dict(m.pipeline.last_run, epoch=epoch))
        return loss
    m._train_epoch = run
    return runs


def check_routes(tag: str, m, runs: list, card: str) -> int:
    """fit()'s epochs of model m all on the captured route, one replay a
    step, the graph captured once; returns the warm-up steps run."""
    steps = m.pipeline.num_batches
    for r in runs:
        print(f"{tag} fit() epoch {r['epoch']}: route {r['route']}, "
              f"{r.get('replays')} replays of {steps} steps, "
              f"{r.get('warmup_steps')} warm-up steps, capture "
              f"{r.get('capture_seconds')} s  [{card}]", flush=True)
        require(r["route"] == "captured" and r["replays"] == steps,
                f"{tag}: fit() epoch {r['epoch']} ran {r}")
    require(sum(r["capture_seconds"] > 0 for r in runs) == 1,
            f"{tag}: the graph captured once in fit(), not {runs}")
    return sum(r["warmup_steps"] for r in runs)


# the models whose serving reads cached user vectors (the towers); the
# others of check_fresh read cached or frozen item and user tables
USER_VECTOR_MODELS = ("TransRec", "SGAT", "CDAE", "MultVAE")


def derived_tables(tag: str, m) -> tuple:
    """What serving and evaluation of model m (FPMC, TransRec, SGAT, MGCN,
    SelfCF, CDAE, MultVAE, BM3, SLMRec) derive from its parameters and
    cache: FPMC's concatenated tables, the user vectors of the first
    B_EVAL users of the towers (SGAT's read its propagated items), the
    frozen embeddings of the graph models; copies."""
    u = torch.arange(B_EVAL, device=m.device)
    with torch.no_grad():
        out = ((m._cached_user_vectors(u),) if tag in USER_VECTOR_MODELS
               else m._chunk_embeddings())
    return tuple(t.clone() for t in out)


def check_fresh(tag: str, m, before: tuple) -> None:
    """After fit()'s captured epochs (replays that move no version
    counter; the pipeline moves them after the epoch) the tables of
    :func:`derived_tables` equal, bit for bit, the same tables computed
    anew from the parameters, and differ from ``before`` (the caches
    filled before fit())."""
    u = torch.arange(B_EVAL, device=m.device)
    got = derived_tables(tag, m)
    with torch.no_grad():
        if tag == "FPMC":
            want = (torch.cat([m.UI, m.LI[m.last_items]], 1),
                    torch.cat([m.IU, m.IL], 1))
        elif tag in ("TransRec", "CDAE", "MultVAE"):
            want = (m._user_vectors(u),)
        elif tag == "SGAT":
            items = sgat_propagate(m.graph, m.item_emb, m.user_emb,
                                   m.config.n_layers)
            want = (head_embedding(items, m.test_seqs[u], m.num_items)
                    + m.user_emb[u],)
        else:
            want = m._embeddings()
    fresh = all(same_bits(a, b) for a, b in zip(got, want))
    moved = not any(same_bits(a, b) for a, b in zip(got, before))
    print(f"{tag} after fit(): the derived tables serving and evaluation "
          f"read equal those of the trained parameters {fresh}, moved from "
          f"before fit() {moved}", flush=True)
    require(fresh and moved, f"{tag}: stale derived tables after fit()")


def epoch_generators(m, epoch: int) -> tuple:
    """The generators of model m's epoch ``epoch`` of seed SEED: the
    pipeline's and the steps' own draws (stream 1)."""
    return (epoch_generator(SEED + 1, epoch, m.device),
            epoch_generator(SEED + 1, epoch, m.device, stream=1))


def epoch_routes(m, tag: str, card: str, kernel: str = None) -> dict:
    """Phases 4, 6, 11, 12 and 14: model m's epoch (seed SEED, an epoch
    fit() did not run) on the captured route and on the eager route, each
    from the same weights, Adam state (MultVAE's anneal count) and
    generators: the loss, every parameter, Adam's moments and step count
    and both generators' end states equal bit for bit, the captured epoch
    replaying the graph fit() captured. Then the busy share of one more
    whole epoch on each route (torch.profiler): the captured one must
    show device time, and ``kernel`` among its kernels where given (the
    profiler records a replay's kernels). Prints each route's seconds
    with the card's name and power limit; returns them."""
    pipe = m.pipeline
    require(m.captured_epochs, f"{tag}: fit() on the card takes the "
            f"captured route")
    start = cpu_copy(m._train_state())
    out = {}
    for route in ("captured", "eager"):
        m._load_train_state(start)            # in place: the same buffers
        gens = epoch_generators(m, EPOCHS)
        loss, sec = timed(lambda: m.run_epoch(
            *gens, captured=route == "captured"))
        out[route] = {"loss": loss, "seconds": sec,
                      "state": flat(cpu_copy(m._train_state())),
                      "gens": [g.get_state() for g in gens],
                      "run": dict(pipe.last_run)}
    cap, eag = out["captured"], out["eager"]
    require(cap["run"]["warmup_steps"] == 0,
            f"{tag}: the loaded state was captured anew: {cap['run']}")
    same_bits_ = (cap["loss"] == eag["loss"]
                  and bit_equal_states(cap["state"], eag["state"])
                  and all(torch.equal(a, b)
                          for a, b in zip(cap["gens"], eag["gens"])))
    diff = max(float((cap["state"][k].double() - v.double()).abs().max())
               for k, v in eag["state"].items())
    print(f"{tag} one epoch ({pipe.num_batches} steps) from one state: "
          f"captured loss {cap['loss']} in {cap['seconds']} s, eager loss "
          f"{eag['loss']} in {eag['seconds']} s; parameters, Adam moments "
          f"and step count, generators bit-equal {same_bits_} (largest "
          f"difference {diff})  [{card}]", flush=True)
    require(same_bits_, f"{tag}: the captured epoch differs from the eager "
            f"one (loss {cap['loss']} vs {eag['loss']}, {diff})")
    for route in ("captured", "eager"):
        gens = epoch_generators(m, EPOCHS + 1)
        busy, heads = busy_share(lambda: m.run_epoch(
            *gens, captured=route == "captured"), reps=1, warm=False,
            top=40)
        out[route]["busy"] = busy
        print(f"{tag} one whole epoch, {route} route: device busy "
              f"{'not measured' if busy is None else busy}; top device "
              f"kernels (ms, calls) {heads[:6]}  [{card}]", flush=True)
        if route == "captured":
            require(busy is not None, f"{tag}: the profiler recorded no "
                    f"device time of the replays")
            require(kernel is None or any(kernel in h[0] for h in heads),
                    f"{tag}: {kernel} not among the replays' kernels")
    m._invalidate_predict_cache()
    return {route: (r["seconds"], r["busy"]) for route, r in out.items()}


def phase_fit_and_models(root, path, reg, model_cls, dev, rng, test_users):
    """Phase 8 (the module docstring): lazy-Adam BPRMF with checkpoints,
    its step against the plain version, two runs from one seed, resume,
    the profiler trace and evaluate_group(); then Pop, AOBPR and CML at
    Gowalla scale. Returns the models and the launch counts of each
    main-path run."""
    t_phase = time.perf_counter()
    ck_dir = os.path.join(root, "checkpoints")
    prof_dir = os.path.join(root, "profile")
    lazy_cfg = {"n_dim": DIM, "epochs": EPOCHS, "early_stop": EPOCHS,
                "optimizer": "lazy_adam"}

    def lazy_run(**over):
        return RunConfig(recommender="BPRMF", data_dir=path, seed=SEED,
                         checkpoint_dir=ck_dir, checkpoint_every=1, **over)
    lazy = cut_eval(model_cls(lazy_run(), dict(lazy_cfg)))
    cut_epoch(lazy, EPOCH_STEPS)
    require(isinstance(lazy.optimizer, LazyAdam), "lazy Adam built")
    # 1. epoch 0 alone, from the state fit() then starts from
    start = cpu_copy(lazy._train_state())
    lazy._train_epoch(0)
    alone = cpu_copy(lazy._train_state())
    lazy._load_train_state(start)
    require(bit_equal_states(flat(cpu_copy(lazy._train_state())),
                             flat(start)), "the state restored in place")
    lazy_best, lazy_launches = counted(lazy.fit)
    lazy_losses = [h["loss"] for h in lazy.history]
    print(f"launches during lazy-Adam BPRMF fit() ({EPOCHS} epochs + "
          f"{EPOCHS} evaluations): {lazy_launches}")
    require(len(lazy_losses) == EPOCHS
            and bool(np.isfinite(lazy_losses).all())
            and lazy_losses[1] < lazy_losses[0],
            f"lazy Adam losses finite and falling: {lazy_losses}")
    for kname in ("submax", "kth_largest", "extract", "rank_count"):
        require(lazy_launches[kname] >= 1,
                f"{kname} never launched in lazy-Adam fit()")
    require(all(getattr(lazy, k).grad is None for k in BPRMF_TABLES),
            "lazy Adam formed a table gradient")
    ckpt = Checkpointer(os.path.join(ck_dir, "BPRMF"))
    require(ckpt._steps() == [0, 1], f"checkpoints {ckpt._steps()}")
    saved0, _, _ = ckpt.restore(0, map_location="cpu")
    saved1, extra1, _ = ckpt.restore(1, map_location="cpu")
    # 2. two runs of epoch 0 from one seed: alone, and inside fit() (its
    # checkpoint of epoch 0)
    run_diff = max(float((t.double() - flat(saved0)[k].double()).abs()
                         .max()) for k, t in flat(alone).items())
    print(f"two runs of epoch 0 from seed {SEED}: bit-equal "
          f"{bit_equal_states(flat(alone), flat(saved0))}, largest "
          f"difference {run_diff} (rows summed in an order the rows fix, no "
          f"atomics)", flush=True)
    require(bit_equal_states(flat(alone), flat(saved0)),
            "two runs of one epoch from one seed differ")
    # 3. one lazy step on the card against the same step on CPU copies
    batch = next(lazy.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))
    before = cpu_copy(lazy._train_state())
    cpu_step, cpu_opt = bprmf_lazy_train_step(
        {k: v.clone() for k, v in before["params"].items()}, lazy.config.lr,
        lazy.config.reg)
    cpu_opt.load_state_dict(cpu_copy(before["optimizer"]))
    versions = [getattr(lazy, k)._version for k in BPRMF_TABLES]
    loss_card = lazy.train_step(batch)
    loss_cpu = cpu_step(tuple(t.cpu() for t in batch))
    # the tables are written as themselves: caches keyed on their version
    # counters (serving's packed table) see the step
    require(all(getattr(lazy, k)._version > v
                for k, v in zip(BPRMF_TABLES, versions)),
            "a lazy step left a table's version counter")
    after = cpu_copy(lazy._train_state())
    users_b, pos_b, neg_b = (t.cpu() for t in batch[:3])
    hit = {"user_emb": torch.unique(users_b),
           "item_emb": torch.unique(torch.cat([pos_b, neg_b[:, 0]]))}
    hit["item_bias"] = hit["item_emb"]
    step_errs = {}
    for k in BPRMF_TABLES:
        touched = torch.zeros(before["params"][k].shape[0], dtype=torch.bool)
        touched[hit[k]] = True
        pairs = [(after["params"][k], cpu_opt.tables[k],
                  before["params"][k])]
        pairs += [(after["optimizer"][k][f], getattr(cpu_opt.states[k], f),
                   before["optimizer"][k][f]) for f in ("m", "v", "counts")]
        for name_, (card_t, plain_t, old_t) in zip(
                ("table", "m", "v", "counts"), pairs):
            require(card_t[~touched].numpy().tobytes()
                    == old_t[~touched].numpy().tobytes(),
                    f"{k} {name_}: an untouched row changed")
            err = float((card_t[touched].double()
                         - plain_t[touched].double()).abs().max())
            scale = float(plain_t[touched].double().abs().max())
            step_errs[f"{k}.{name_}"] = err
            require(err <= 1e-5 * scale + 1e-30,
                    f"{k} {name_}: touched rows card vs plain {err} "
                    f"(scale {scale})")
    print(f"one lazy step card vs plain on CPU copies (touched rows within "
          f"1e-5 of each tensor's largest magnitude, untouched rows, moments "
          f"and counts bit-unchanged): loss {float(loss_card)} vs "
          f"{float(loss_cpu)}, max abs err {step_errs}", flush=True)
    # 4. resume: a new model starts after the last checkpoint, its state
    # bit-equal to what was saved
    restored, es_states = [], []
    set_state = EarlyStopping.set_state

    def spy_set_state(self_, state):
        set_state(self_, state)
        es_states.append(self_.get_state())
    EarlyStopping.set_state = spy_set_state
    try:
        resumed = cut_eval(model_cls(lazy_run(resume=True),
                                     dict(lazy_cfg, epochs=3)))
        cut_epoch(resumed, EPOCH_STEPS)
        first_epoch = resumed._train_epoch

        def snapshot_then_train(epoch):
            restored.append(cpu_copy(resumed._train_state()))
            resumed._train_epoch = first_epoch
            return first_epoch(epoch)
        resumed._train_epoch = snapshot_then_train
        _, resume_launches = counted(resumed.fit)
    finally:
        EarlyStopping.set_state = set_state
    require([h["epoch"] for h in resumed.history] == [2],
            f"resumed epochs {[h['epoch'] for h in resumed.history]}")
    require(bit_equal_states(flat(restored[0]), flat(saved1)),
            "the restored state differs from the saved one")
    require(json.loads(json.dumps(es_states[0]))
            == extra1["early_stopping"], "early stopping not restored")
    require(bool(np.isfinite(resumed.history[0]["loss"])),
            "resumed loss finite")
    print(f"resume: started at epoch 2, parameters, moments, counts and "
          f"early stopping ({es_states[0]['counter']} without a gain) "
          f"bit-equal to checkpoint 1; loss {resumed.history[0]['loss']}",
          flush=True)
    # 5. the profiler trace of the same model's second epoch
    shutil.rmtree(prof_dir, ignore_errors=True)
    resumed.run_config.resume = False
    resumed.run_config.checkpoint_every = 0
    resumed.run_config.profile_dir = prof_dir
    resumed.config.epochs = 2
    # both epochs cut to their first TRAIN_WINDOW steps: a trace of a
    # whole epoch runs to ~490 MB and ~30 s
    resumed.pipeline.num_batches = TRAIN_WINDOW
    (_, prof_sec), prof_launches = counted(lambda: timed(resumed.fit))
    (trace_name,) = os.listdir(prof_dir)
    trace_path = os.path.join(prof_dir, trace_name)
    with open(trace_path) as f:
        trace = json.load(f)
    kernel_names = {e["name"] for e in trace.get("traceEvents", ())
                    if e.get("cat") == "kernel"}
    ours = sorted({k for k in ("submax", "extract", "rank_count")
                   if any(k in n for n in kernel_names)})
    print(f"profile_dir: {trace_name}, {os.path.getsize(trace_path)} bytes, "
          f"{len(kernel_names)} kernel names, the port's {ours}; fit() with "
          f"the trace {prof_sec} s", flush=True)
    require(os.path.getsize(trace_path) > 0 and ours,
            "the trace shows none of the port's kernels")
    del trace
    # 6. evaluate_group(): the groups' means, weighted by their test users
    (group_reports, group_launches) = counted(lazy.evaluate_group)
    test_set = set(lazy.evaluator.user_pos_test)
    counts = [sum(int(u) in test_set for u in g.users)
              for g in lazy._user_groups]
    covered = [int(u) for g in lazy._user_groups for u in g.users
               if int(u) in test_set]
    missing = len(test_set) - len(covered)
    whole = lazy.evaluate() if missing == 0 else lazy.evaluate(covered)
    mean = sum(c * np.array(list(r.values()))
               for c, (_, r) in zip(counts, group_reports)) / sum(counts)
    group_diff = float(np.abs(mean - np.array(list(whole.values()))).max())
    print(f"evaluate_group(): {[(lbl, c) for (lbl, _), c in zip(group_reports, counts)]}"
          f" (label, test users); {missing} test users in no group; "
          f"weighted mean vs evaluate() largest difference {group_diff}",
          flush=True)
    require(len(group_reports) == 4 and group_diff <= 1e-6,
            f"group means off by {group_diff}")
    # 7. Pop: whole-catalog ties
    reg.load_skrx_model("Pop")
    pop = reg.get_model("Pop")[0](RunConfig(recommender="Pop", data_dir=path,
                                            seed=SEED), {})
    pop_best, pop_launches = counted(pop.fit)
    require(pop.history[0]["loss"] is None and "report" in pop.history[0],
            "Pop: nothing trained, one evaluation")
    for kname in ("submax", "kth_largest", "extract", "rank_count"):
        require(pop_launches[kname] >= 1, f"{kname} never launched in Pop")
    n_check = min(B_KERNEL, len(test_users))
    u = rng.choice(test_users, n_check, replace=False)
    pop_err = metrics_card_vs_plain(pop, u)
    p_sc = pop.predict(u)
    p_tr = torch.from_numpy(pop.evaluator._tables_for(u, pop.num_items)[0]
                            ).to(dev)
    p_masked = metrics.mask_items(p_sc, p_tr)
    kth = torch.topk(p_masked, K_EVAL, dim=1).values[:, -1]
    ties = (p_masked == kth[:, None]).sum(1).double()
    _, _, p_tau = tb.blockwise_candidates(p_sc, K_EVAL, BLOCK_N, p_tr)
    p_pad = tb._masked_padded(p_sc, p_tr, BLOCK_N).reshape(n_check, -1,
                                                           BLOCK_N)
    p_found = ((p_pad >= p_tau[:, None, None]) & (p_pad != NEG_INF)).sum(2)
    del p_pad, p_masked
    print(f"Pop: NDCG@10 {pop_best['NDCG@10']}; per-user metrics of "
          f"{n_check} users card vs plain max abs err {pop_err}; items tied "
          f"at the k-th place (k={K_EVAL}) a row: min {float(ties.min())}, "
          f"median {float(ties.median())}, max {float(ties.max())}; "
          f"survivors of a 4,096-column block at tau: max "
          f"{int(p_found.max())}, {int((p_found > RANK_CAP).sum())} blocks "
          f"above F={RANK_CAP}; launches {pop_launches}", flush=True)
    # 8. AOBPR at its defaults, one epoch with a re-sort inside it
    reg.load_skrx_model("AOBPR")
    ao = reg.get_model("AOBPR")[0](RunConfig(recommender="AOBPR",
                                             data_dir=path, seed=SEED),
                                   {"epochs": 1, "early_stop": 1})
    require(ao.config.embed_size == DIM
            and 0 < ao.resort_every < ao.num_batches,
            f"AOBPR re-sorts at step {ao.resort_every} of {ao.num_batches}")
    # its epoch cut past its first re-sort
    cut_eval(ao)
    cut_epoch(ao, EPOCH_STEPS and max(EPOCH_STEPS, ao.resort_every + 1))
    ao_best, ao_launches = counted(ao.fit)
    require(bool(np.isfinite(ao.history[0]["loss"])), "AOBPR loss finite")
    ao_runs = {}
    for mode in ("full", "fused"):
        (rep, sec), launched = counted(lambda: evaluate_as(ao, mode))
        ao_runs[mode] = (rep, sec, launched)
    ao_diff = float(np.abs(np.array(list(ao_runs["fused"][0].values()))
                           - np.array(list(ao_runs["full"][0].values())))
                    .max())
    for kname in FUSED + ("rank_lookup_count",):
        require(ao_runs["fused"][2][kname] >= 1,
                f"{kname} never launched in AOBPR's fused evaluate()")
    require(ao_diff <= 1e-4, f"AOBPR fused vs full metrics off by {ao_diff}")
    print(f"AOBPR: {ao.num_batches} steps, re-sort every "
          f"{ao.resort_every}; loss {ao.history[0]['loss']}, NDCG@10 "
          f"{ao_best['NDCG@10']}; fused vs full largest metric difference "
          f"{ao_diff}; fused launches {ao_runs['fused'][2]}", flush=True)
    # 9. CML at its defaults, one epoch
    reg.load_skrx_model("CML")
    cml = reg.get_model("CML")[0](RunConfig(recommender="CML", data_dir=path,
                                            seed=SEED),
                                  {"epochs": 1, "early_stop": 1})
    cml_best, cml_launches = counted(cml.fit)
    require(bool(np.isfinite(cml.history[0]["loss"])), "CML loss finite")
    for kname in ("submax", "kth_largest", "extract", "rank_count"):
        require(cml_launches[kname] >= 1, f"{kname} never launched in CML")
    pairs = cml.dataset.train_data.to_user_item_pairs()
    norms = [float(torch.linalg.vector_norm(
        t.detach()[torch.as_tensor(np.unique(col), device=dev)], dim=1).max())
        for t, col in ((cml.user_emb, pairs[:, 0]), (cml.item_emb,
                                                     pairs[:, 1]))]
    require(max(norms) <= cml.config.clip_norm * (1 + 1e-5),
            f"CML touched rows above clip_norm: {norms}")
    cml_err = metrics_card_vs_plain(
        cml, rng.choice(test_users, n_check, replace=False))
    print(f"CML: {cml.pipeline.num_batches} steps of {cml.config.batch_size}"
          f" (dns {cml.config.dns}); loss {cml.history[0]['loss']}, NDCG@10 "
          f"{cml_best['NDCG@10']}; largest norm of a trained user / item row "
          f"{norms} (clip_norm {cml.config.clip_norm}); per-user metrics card "
          f"vs plain max abs err {cml_err}", flush=True)
    print(f"phase 8 took {time.perf_counter() - t_phase} s", flush=True)
    return {"lazy": lazy, "pop": pop, "ao": ao, "cml": cml,
            "runs": [lazy_launches, resume_launches, prof_launches,
                     group_launches, pop_launches, ao_launches,
                     *(r[2] for r in ao_runs.values()), cml_launches]}



def nested_cpu(x):
    """Tensors in nested lists and tuples copied to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(nested_cpu(v) for v in x)
    return x


def step_card_vs_cpu(tag, m, cpu_loss, batch, masks, card_step=None,
                     cpu_optimizer=None, zero_grad_params=None) -> dict:
    """One train step of model m on the card against the same step on CPU
    copies of its parameters, Adam state, batch and masks:
    ``cpu_loss(params, *batch, masks)`` is the model's loss over CPU copies
    of its operators, whose propagation runs segsum's plain version (a
    model whose step draws nothing passes masks None and takes
    ``cpu_loss(params, *batch)``). ``card_step(args) -> loss`` is the
    model's step (``m.train_step``), ``cpu_optimizer(groups)`` builds the
    CPU copy's optimizer over param groups of the same layout (a
    ``torch.optim.Adam`` of the model's defaults). The loss within 1e-5
    relative, every updated parameter within 1e-5 of its largest
    magnitude. A parameter that is a key of ``zero_grad_params`` has a
    gradient that is 0 but for rounding (an attention's key bias, which
    the softmax cancels), and Adam turns that noise, which differs between
    the card and the CPU, into steps that differ as much as they are
    large; it is held within 1e-5 of the largest magnitude of the
    parameter its value names instead (the key weight beside it, the
    scale at which it enters the logits)."""
    named = dict(m.named_parameters())
    flat_step = getattr(m, "_flat_step", None)
    if flat_step is None:
        by_id = {id(p): n for n, p in named.items()}
        groups = [[by_id[id(p)] for p in g["params"]]
                  for g in m.optimizer.param_groups]
        opt_state = m.optimizer.state_dict()
    else:
        # a flat step: its state as a per-parameter Adam's, whose update is
        # the same elementwise one
        groups = [list(flat_step.names)]
        opt_state = flat_step.state_dict()
    order = [n for g in groups for n in g]
    params = {n: named[n].detach().cpu().clone().requires_grad_(True)
              for n in order}
    if cpu_optimizer is None:
        # the port's Adam on the CPU: not capturable there, also with the
        # card's (capturable) state loaded; its bias corrections are f64
        # on the host, the card's f32 (a step's size apart by ~1e-5 of it)
        cpu_opt = adam_l2([params[n] for n in order],
                          float(m.optimizer.defaults["lr"]),
                          m.optimizer.defaults["weight_decay"])
    else:
        cpu_opt = cpu_optimizer([[params[n] for n in g] for g in groups])
    cpu_opt.load_state_dict(cpu_copy(opt_state))
    if flat_step is not None:
        # the rate the card's step takes: its schedule's, computed on the
        # card from Adam's count (MGCN), or the constant one
        rate = flat_step.next_lr()
        for g in cpu_opt.param_groups:
            g["lr"] = float(m.optimizer.defaults["lr"] if rate is None
                            else rate)
    cpu_step = make_train_step(cpu_opt,
                               lambda *b: cpu_loss(params, *b))
    args = tuple(batch) if masks is None else (*batch, masks)
    zero_grad_params = zero_grad_params or {}
    loss_cpu = float(cpu_step(nested_cpu(args)))
    loss_card = float((card_step or m.train_step)(args))
    errs = {"loss": abs(loss_card - loss_cpu) / abs(loss_cpu)}
    require(errs["loss"] <= 1e-5, f"{tag}: loss card {loss_card} vs CPU "
            f"{loss_cpu}")
    for n in order:
        err = float((named[n].detach().cpu().double()
                     - params[n].detach().double()).abs().max())
        scale = float(params[zero_grad_params.get(n, n)].detach().abs()
                      .max())
        errs[n] = err
        require(err <= 1e-5 * scale + 1e-30,
                f"{tag} {n}: card vs CPU after one step {err} (scale "
                f"{scale})")
    print(f"{tag}: one train step card vs CPU copies (segsum's plain "
          f"version): loss {loss_card} vs {loss_cpu}; relative loss error "
          f"and max abs parameter errors {errs}", flush=True)
    return errs


def fit_counted(m, steps_per_epoch: int, props: int, tag: str,
                sums=(0, 0, 0), route: str = None, card: str = ""):
    """fit() of a model with its launches counted: losses finite, segsum
    launched exactly ``props`` propagations forward and backward a step
    plus ``props`` an evaluation (none for a model without a graph), and
    ``sums`` (a step's, an epoch's, an evaluation's) fixed-index sums on
    top, the full route's kernels launched. ``route``: every epoch must
    take it ("captured": one replay a step, one capture, and the capture's
    warm-up steps launch as steps; "eager"); None: not read."""
    runs = traced_routes(m) if route is not None else None
    best, launched = counted(m.fit)
    losses = [h["loss"] for h in m.history]
    evals = sum("report" in h for h in m.history)
    per_step, per_epoch, per_eval = sums
    warm = 0
    if route == "captured":
        warm = check_routes(tag, m, runs, card)
    elif route == "eager":
        require(all(r["route"] == "eager" for r in runs),
                f"{tag}: fit() left the eager route: {runs}")
    expect = (len(losses) * (steps_per_epoch * (2 * props + per_step)
                             + per_epoch) + (props + per_eval) * evals
              + warm * (2 * props + per_step))
    print(f"{tag} fit() ({len(losses)} epochs of {steps_per_epoch} steps, "
          f"{evals} evaluations, route {route or 'not read'}, {warm} "
          f"warm-up steps): losses {losses}, NDCG@10 {best['NDCG@10']}; "
          f"launches {launched}; expected segsum {expect}", flush=True)
    require(bool(np.isfinite(losses).all()), f"{tag} losses {losses}")
    require(launched["segsum"] == expect,
            f"{tag}: segsum {launched['segsum']} launches, not {expect}")
    for kname in ("submax", "kth_largest", "extract", "rank_count"):
        require(launched[kname] >= 1, f"{kname} never launched in {tag}")
    return launched


# the kernels each evaluate() route must launch (a chunk of CHUNK items is
# too narrow for the blockwise kernels at k=50: the chunked route merges
# each chunk's top-k through vmem_topk, pruned_merge's kernel at tau=-inf)
ROUTE_KERNELS = {"full": ("submax", "kth_largest", "extract", "rank_count"),
                 "fused": FUSED + ("kth_largest", "rank_lookup_count"),
                 "chunked": ("vmem_topk",)}


def evaluate_routes(m, tag: str, modes) -> dict:
    """evaluate() on each route (chunked at CHUNK items a chunk) with its
    launches: finite metrics, every other route within 1e-4 of the full
    route's, each route's kernels launched."""
    runs = {}
    for mode in modes:
        (rep, sec), launched = counted(lambda: evaluate_as(m, mode, CHUNK))
        runs[mode] = (rep, sec, launched)
        for kname in ROUTE_KERNELS[mode]:
            require(launched[kname] >= 1,
                    f"{kname} never launched in {mode} evaluate() of {tag}")
    full = np.array(list(runs["full"][0].values()))
    require(bool(np.isfinite(full).all()), f"{tag}: metrics {full}")
    diffs = {mode: float(np.abs(np.array(list(runs[mode][0].values()))
                                - full).max()) for mode in modes[1:]}
    print(f"{tag} evaluate(): {[(mode, r[1]) for mode, r in runs.items()]} "
          f"(route, s); NDCG@10 {runs['full'][0]['NDCG@10']}; largest "
          f"metric difference to the full route {diffs}", flush=True)
    for mode, diff in diffs.items():
        require(diff <= 1e-4, f"{tag} {mode}: metrics off by {diff}")
    return runs


def phase_graph_models(path, reg, dev):
    """Phase 10 (the module docstring): LayerGCN, LightGCL and DENS at
    Gowalla scale. Returns the models and the launch counts of each
    main-path run."""
    t_phase = time.perf_counter()

    def build(name, cfg):
        reg.load_skrx_model(name)
        m = cut_eval(reg.get_model(name)[0](
            RunConfig(recommender=name, data_dir=path, seed=SEED), cfg))
        cut_epoch(m, EPOCH_STEPS)
        return m
    # LayerGCN: epoch 0 pruned by degree, epoch 1 at random
    lg = build("LayerGCN", {"dropout": 0.1, "epochs": EPOCHS,
                            "early_stop": EPOCHS})
    lcfg, e = lg.config, lg.num_pairs
    require(lcfg.embed_dim == DIM and lg.user_emb.device == dev
            and lg.graph.num_edges == 2 * e, "LayerGCN at full width")
    masks = [lg.epoch_mask(epoch) for epoch in range(EPOCHS)]
    base = lg._base
    for epoch, mask in enumerate(masks):
        kept = int((mask[:e] != 0).sum())
        require(bool(torch.equal(mask[:e], mask[e:])) and kept == lg.keep_len,
                f"LayerGCN epoch {epoch} keeps {kept} of {e}, not "
                f"{lg.keep_len}")
    print(f"LayerGCN: {e} pairs, {lg.graph.num_edges} edges, keep_len "
          f"{lg.keep_len}; mean base weight of the kept pairs: by degree "
          f"(epoch 0) {float(base[masks[0][:e] != 0].mean())}, at random "
          f"(epoch 1) {float(base[masks[1][:e] != 0].mean())}, all "
          f"{float(base.mean())}", flush=True)
    lg_launches = fit_counted(lg, lg.pipeline.num_batches,
                                  lcfg.n_layers, "LayerGCN")
    batch = next(lg.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))
    g_cpu = lg.graph.to("cpu")
    step_card_vs_cpu(
        "LayerGCN (epoch 0's pruning mask)", lg,
        lambda p, u, pos, neg, w, mask: layergcn_loss(
            g_cpu, p, lcfg, u, pos, neg, w, mask), batch, masks[0])
    lg_runs = evaluate_routes(lg, "LayerGCN", ("full",))
    # LightGCL at its defaults; its step with dropout 0.25
    gcl = build("LightGCL", {"epochs": 1, "early_stop": 1})
    gcfg, ops = gcl.config, gcl.ops
    require(gcfg.d == DIM and ops.u_mul_s.shape == (USERS, gcfg.svd_q)
            and ops.r.num_nodes == USERS and ops.r.num_src_nodes == ITEMS,
            "LightGCL at full width")
    print(f"LightGCL: R {USERS} x {ITEMS}, {ops.r.num_edges} edges, SVD "
          f"rank {gcfg.svd_q}; ready after {time.perf_counter() - t_phase} "
          f"s of the phase", flush=True)
    gcl_launches = fit_counted(gcl, gcl.pipeline.num_batches,
                                   2 * gcfg.gnn_layer, "LightGCL")
    batch = next(gcl.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))
    drop = lightgcl_dropout_masks(torch.Generator(dev).manual_seed(SEED),
                                  ops.r.num_edges, gcfg.gnn_layer, 0.25)
    ops_cpu = ops.to("cpu")
    step_card_vs_cpu(
        "LightGCL (dropout 0.25)", gcl,
        lambda p, u, pos, neg, w, m_: lightgcl_loss(
            ops_cpu, p, gcfg, u, pos, neg, w, m_), batch, drop)
    gcl_runs = evaluate_routes(gcl, "LightGCL", ("full", "fused"))
    # DENS at its defaults (ns "dens", K 1, 6 candidates); its step with
    # edge and message dropout
    dn = build("DENS", {"epochs": 1, "early_stop": 1})
    dcfg = dn.config
    require(dcfg.dim == DIM and dcfg.ns == "dens"
            and dn.pipeline.num_neg == dcfg.K * dcfg.n_negs,
            "DENS at its defaults")
    dn_launches = fit_counted(dn, dn.pipeline.num_batches,
                                  dcfg.context_hops, "DENS")
    batch = next(dn.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))
    dcfg.edge_dropout = dcfg.mess_dropout = True       # for this step only
    drop = dens_dropout_masks(torch.Generator(dev).manual_seed(SEED),
                              dn.graph, dcfg.context_hops, dcfg.dim,
                              dcfg.edge_dropout_rate, dcfg.mess_dropout_rate)
    d_cpu = dn.graph.to("cpu")
    step_card_vs_cpu(
        "DENS (edge and message dropout 0.1)", dn,
        lambda p, u, pos, neg, w, m_: dens_loss(
            d_cpu, p, dcfg, u, pos, neg, w, dn.anneal, m_), batch, drop)
    dcfg.edge_dropout = dcfg.mess_dropout = False
    dn_runs = evaluate_routes(dn, "DENS", ("full", "fused"))
    print(f"phase 10 took {time.perf_counter() - t_phase} s", flush=True)
    return {"LayerGCN": lg, "LightGCL": gcl, "DENS": dn,
            "runs": [lg_launches, gcl_launches, dn_launches,
                     *(r[2] for runs in (lg_runs, gcl_runs, dn_runs)
                       for r in runs.values())]}


def phase_selfcf_and_autoencoders(path, reg, dev, card: str, errs: dict):
    """Phase 11 (the module docstring): SelfCF, CDAE and MultVAE at Gowalla
    scale, each fit() on the captured route (their draws replayed from
    the epoch program's step generator), the derived tables fresh after
    it, and one epoch on each route from one state. Returns the models
    and the launch counts of each main-path run."""
    t_phase = time.perf_counter()

    def build(name):
        reg.load_skrx_model(name)
        m = cut_eval(reg.get_model(name)[0](
            RunConfig(recommender=name, data_dir=path, seed=SEED),
            {"epochs": 1, "early_stop": 1}))
        cut_epoch(m, EPOCH_STEPS)
        return m

    def first_batch(m):
        return next(m.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))
    # SelfCF: a fresh edge mask of random rate every step
    sc = build("SelfCF")
    scfg, e = sc.config, sc.graph.num_edges
    require(scfg.embed_dim == DIM and scfg.n_layers == 2
            and e == 2 * sc.pipeline.num_examples
            and sc.user_emb.device == dev, "SelfCF at its defaults")
    print(f"SelfCF: {e} edges, {sc.pipeline.num_batches} steps of "
          f"{scfg.batch_size}; ready after {time.perf_counter() - t_phase} "
          f"s of the phase", flush=True)
    before = derived_tables("SelfCF", sc)
    sc_launches = fit_counted(sc, sc.pipeline.num_batches, scfg.n_layers,
                              "SelfCF", route="captured", card=card)
    check_fresh("SelfCF", sc, before)
    batch = first_batch(sc)
    for s in range(SEED, SEED + 100):  # the first seed drawing rate > 0.5
        draws = selfcf_draws(torch.Generator(dev).manual_seed(s), e,
                             batch[0].shape[0], scfg.embed_dim, scfg.dropout)
        scale = float(draws[0].max())
        if scale > 2.0:
            break
    require(scale > 2.0, "no drawn rate above 0.5")
    g_cpu = sc.graph.to("cpu")
    step_card_vs_cpu(
        f"SelfCF (edge rate {1 - 1 / scale}, kept edges x {scale})", sc,
        lambda p, u, pos, w, d: selfcf_loss(g_cpu, p, scfg, u, pos, w, *d),
        batch, draws)
    epoch_routes(sc, "SelfCF", card, "segsum")
    sc_runs = evaluate_routes(sc, "SelfCF", ("full", "fused", "chunked"))
    # CDAE: n_pos * num_neg negatives a user, a (B, N) dropout mask a step
    cd = build("CDAE")
    ccfg = cd.config
    require(ccfg.hidden_dim == DIM and ccfg.num_neg == 5
            and cd.en_emb.shape == (ITEMS, DIM), "CDAE at its defaults")
    print(f"CDAE: {cd.pipeline.num_batches} steps of {ccfg.batch_size} "
          f"users, {cd.max_k} negative slots a user", flush=True)
    before = derived_tables("CDAE", cd)
    cd_launches = fit_counted(cd, cd.pipeline.num_batches, 0, "CDAE",
                              route="captured", card=card)
    check_fresh("CDAE", cd, before)
    batch = first_batch(cd)
    draws = cdae_draws(torch.Generator(dev).manual_seed(SEED), batch[0],
                       cd.pipeline.pos_table, ITEMS, cd.max_k, ccfg.dropout)
    lengths_cpu = cd.pos_lengths.cpu()
    step_card_vs_cpu(
        "CDAE (negatives, dropout 0.5)", cd,
        lambda p, u, rows, w, d: cdae_loss(p, ccfg, lengths_cpu, u, rows, w,
                                           *d), batch, draws)
    epoch_routes(cd, "CDAE", card)
    cd_runs = evaluate_routes(cd, "CDAE", ("full", "fused", "chunked"))
    # MultVAE: the KL anneal from the f32 step count
    mv = build("MultVAE")
    mcfg = mv.config
    require(mv.q_dims == [ITEMS, DIM] and mv.p_dims == [DIM, ITEMS]
            and mv.q[0].weight.shape == (2 * DIM, ITEMS)
            and mcfg.compute_dtype == "float32", "MultVAE at its defaults")
    before = derived_tables("MultVAE", mv)
    mv_launches = fit_counted(mv, mv.pipeline.num_batches, 0, "MultVAE",
                              route="captured", card=card)
    check_fresh("MultVAE", mv, before)
    # the capture's warm-up steps taken back: the anneal's count is fit()'s
    require(float(mv.update_count) == mv.pipeline.num_batches,
            f"MultVAE counted {float(mv.update_count)} steps")
    batch = first_batch(mv)
    draws = multvae_draws(torch.Generator(dev).manual_seed(SEED),
                          batch[0].shape[0], ITEMS, DIM, mcfg.keep_prob)
    anneal = mv.anneal().cpu()
    step_card_vs_cpu(
        f"MultVAE (keep_prob 0.5, anneal {float(anneal)})", mv,
        lambda p, u, rows, w, d: multvae_loss(p, mcfg, rows, w, *d, anneal),
        batch, draws)
    epoch_routes(mv, "MultVAE", card)
    mv_runs = evaluate_routes(mv, "MultVAE", ("full", "fused", "chunked"))
    # the fused kernels on each model's real factors at the evaluation
    # shape (B=64, k=50): SelfCF's 128 wide, the towers' with a bias
    u = np.fromiter(sc.evaluator.user_pos_test, np.int64)[:B_EVAL]
    u_t = torch.as_tensor(u, device=dev)
    train_t = torch.as_tensor(sc.evaluator._tables_for(u, ITEMS)[0],
                              device=dev)
    u_all, i_all = sc._chunk_embeddings()
    factors = {"SelfCF": (u_all[u_t], i_all, None)}
    for tag, m in (("CDAE", cd), ("MultVAE", mv)):
        _, table, bias = m._topk_factors(None)
        factors[tag] = (m._cached_user_vectors(u_t), table, bias)
    for tag, (uv, table, bias) in factors.items():
        require(uv.shape == (B_EVAL, table.shape[1]), f"{tag} factors")
        check_fused(f"{tag} factors (d={table.shape[1]}, bias "
                    f"{bias is not None})", uv.contiguous(),
                    dt.pack_items(table, bias), train_t, K_EVAL, errs)
    # serving through predict: equal to the plain top-k, no seen item
    seen = sc.dataset.train_data.to_user_dict()
    serve_runs = []
    for tag, m in (("SelfCF", sc), ("CDAE", cd), ("MultVAE", mv)):
        server = TopKRecommender(m, k=K)
        (ids, vals), launched = counted(lambda: server.recommend(u))
        check_served(server, u, ids, vals, seen)
        serve_runs.append(launched)
    print(f"phase 11: fused kernels == plain versions on the models' "
          f"factors; recommend() for {len(u)} users of each model equals "
          f"the plain top-k; phase 11 took {time.perf_counter() - t_phase} s",
          flush=True)
    return {"SelfCF": sc, "CDAE": cd, "MultVAE": mv,
            "runs": [sc_launches, cd_launches, mv_launches, *serve_runs,
                     *(r[2] for runs in (sc_runs, cd_runs, mv_runs)
                       for r in runs.values())]}

def check_weighted(wgraph, x, w, ct, errs: dict):
    """propagate_weighted (segsum forward and for dx, dw in PyTorch) on the
    card against float64 on CPU copies: the output and dx by segsum's rule
    (per row |got - ref| <= 1e-5 * sum|msg| + 1e-30, msg the weighted
    messages into the row), dw within 1e-5 * sum_d |g[dst]_d x[src]_d| +
    1e-30 an edge (a 64-term f32 dot stays below 64 * 2^-24 of that sum).
    Returns each error's largest share of its bound."""
    xg = x.detach().clone().requires_grad_(True)
    wg = w.detach().clone().requires_grad_(True)
    out = propagate_weighted(wgraph, xg, wg)
    out.backward(ct)
    g_cpu = wgraph.graph.to("cpu")
    x64, w64, c64 = (t.detach().cpu().double() for t in (x, w, ct))
    src, dst = wgraph.src.cpu(), wgraph.dst.cpu()
    prod = c64[dst] * x64[src]
    cases = {
        "out": (out, ss.segsum_plain(g_cpu.fwd, x64, w64),
                ss.segsum_plain(g_cpu.fwd, x64.abs(), w64.abs())),
        "dx": (xg.grad, ss.segsum_plain(g_cpu.bwd, c64, w64),
               ss.segsum_plain(g_cpu.bwd, c64.abs(), w64.abs())),
        "dw": (wg.grad, prod.sum(-1), prod.abs().sum(-1))}
    shares = {}
    for name, (got, ref, scale) in cases.items():
        got = got.detach().cpu().double()
        err, bound = (got - ref).abs(), 1e-5 * scale + 1e-30
        require(bool(torch.isfinite(got).all()),
                f"propagate_weighted {name}: non-finite")
        require(bool((err <= bound).all()), f"propagate_weighted {name}: "
                f"error {float((err / bound).max())} x the bound")
        shares[name] = float((err / bound).max())
        if name != "dw":
            errs["segsum"] = max(errs.get("segsum", 0.0), float(err.max()))
    require(not bool(wgraph.graph.fwd.merge_count.any()
                     or wgraph.graph.bwd.merge_count.any()),
            "segsum left a counter set")
    return shares


def weighted_times(wgraph, x, w, ct, card: str) -> None:
    """Device times of SGAT's propagation at its graph: segsum with the
    attention as edge weights, its bound by row 11's rule, torch.sparse.mm
    of the CSR matrix with the attention as values, and dw."""
    g = wgraph.graph
    seg = g.fwd
    n, d = x.shape
    e, n_seg = g.num_edges, seg.seg_dst.shape[0]
    n_part, n_merge = seg.num_partials, seg.merge_row.shape[0]
    by_row = torch.argsort(wgraph.dst, stable=True)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
    crow[1:] = torch.cumsum(torch.bincount(wgraph.dst, minlength=n), 0)
    a_csr = torch.sparse_csr_tensor(crow, wgraph.src[by_row], w[by_row],
                                    (n, n))
    require(bool(torch.allclose(torch.sparse.mm(a_csr, x),
                                ss.segsum(seg, x, w), rtol=1e-4, atol=1e-6)),
            "torch.sparse.mm of A(att) computes the same function")
    # x once, the output, each edge's source id, unit weight, original id
    # and attention, the segment and merge tables; a multiply and an add
    # per (edge, feature), the weight's scale per edge, an add per partial
    # feature
    nbytes = 4 * (2 * n * d + 4 * e + 2 * n_seg + 1 + n_part + 4 * n_merge
                  + 1)
    ops = 2 * e * d + e + n_part * d
    t_b, t_o = nbytes / MEM_RATE * 1e3, ops / F32_OPS * 1e3
    # dw: g and x once, the endpoints, dw written; a multiply and an add
    # per (edge, feature)
    dw_b, dw_o = 4 * (2 * n * d + 3 * e) / MEM_RATE * 1e3, \
        2 * e * d / F32_OPS * 1e3

    def dw():
        return torch.sum(ct.index_select(0, wgraph.dst)
                         * x.index_select(0, wgraph.src), dim=-1)
    print(f"segsum at SGAT's graph (N={n}, E={e}, D={d}, {n_seg} segments, "
          f"{n_merge} rows merged from {n_part} partial rows; attention as "
          f"edge weights): {device_ms(lambda: ss.segsum(seg, x, w))} ms of "
          f"device time (one call between CUDA events "
          f"{time_ms(lambda: ss.segsum(seg, x, w))} ms), bound "
          f"{max(t_b, t_o)} ms ({'bytes' if t_b >= t_o else 'operations'}), "
          f"plain {device_ms(lambda: ss.segsum_plain(seg, x, w))} ms, "
          f"library torch.sparse.mm of A(att) "
          f"{device_ms(lambda: torch.sparse.mm(a_csr, x))} ms; dw "
          f"(g[dst] . x[src]) {device_ms(dw)} ms, bound {max(dw_b, dw_o)} ms "
          f"({'bytes' if dw_b >= dw_o else 'operations'})  [{card}]",
          flush=True)


def phase_sequential_models(path, reg, dev, card: str, errs: dict):
    """Phase 12 (the module docstring): FPMC, TransRec, SGAT, Caser and HGN
    at Gowalla scale. Returns the models and the launch counts of each
    main-path run."""
    t_phase = time.perf_counter()

    def build(name, **over):
        reg.load_skrx_model(name)
        return cut_eval(reg.get_model(name)[0](
            RunConfig(recommender=name, data_dir=path, seed=SEED),
            {"epochs": 1, "early_stop": 1, **over}))

    def first_batch(m):
        return next(m.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))
    models, runs = {}, []
    # FPMC and TransRec: one previous item, one next item; a lazy-Adam
    # epoch each besides the dense one
    for name, loss in (("FPMC", fpmc_loss), ("TransRec", transrec_loss)):
        m = build(name)
        require(m.config.embed_size == DIM and m.pipeline.num_neg == 1
                and m.pipeline._prev.shape[1] == 1, f"{name} at its defaults")
        before = derived_tables(name, m)
        runs.append(fit_counted(m, cut_epoch(m, SEQ_STEPS), 0, name,
                                route="captured", card=card))
        check_fresh(name, m, before)
        lazy = build(name, optimizer="lazy_adam")
        runs.append(fit_counted(lazy, cut_epoch(lazy, SEQ_STEPS), 0,
                                f"{name} (lazy Adam)", route="eager"))
        reg_ = m.config.reg
        step_card_vs_cpu(name, m, lambda p, *b, f=loss, r=reg_: f(p, r, *b),
                         first_batch(m), None)
        models[name], models[f"{name} (lazy Adam)"] = m, lazy
    # SGAT: the whole item graph, 5 layers of attention, at every step
    sg = build("SGAT")
    scfg, g = sg.config, sg.graph
    n_edges, n_occ = g.items.graph.num_edges, g.occ_user.shape[0]
    require(scfg.embed_size == DIM and scfg.n_layers == 5
            and scfg.n_seqs == 5 and scfg.n_next == 3
            and sg.item_emb.device == dev, "SGAT at its defaults")
    in_edges = torch.bincount(g.edge_tail, minlength=ITEMS)
    print(f"SGAT: {n_occ} occurrences, {n_edges} edges into "
          f"{int((in_edges > 0).sum())} rows (most in-edges "
          f"{int(in_edges.max())}, most occurrences of an edge "
          f"{int(torch.bincount(g.occ_edge).max())}); "
          f"{sg.pipeline.num_examples} "
          f"examples, {sg.pipeline.num_batches} steps of {scfg.batch_size}; "
          f"ready after {time.perf_counter() - t_phase} s of the phase",
          flush=True)
    with torch.no_grad():                  # layer 1 of the first step
        att = sgat_attention(g, sg.item_emb, sg.user_emb)
    x = sg.item_emb.detach()
    ct = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED))
    shares = check_weighted(g.items, x, att, ct, errs)
    print(f"propagate_weighted at SGAT's graph, the first step's attention "
          f"(sum {float(att.sum())} over {n_edges} edges): out, dx and dw "
          f"within their bounds, largest share of the bound {shares}",
          flush=True)
    weighted_times(g.items, x, att, ct, card)
    # a layer's attention: two fixed-index sums forward, the gradients of
    # its four fixed gathers backward
    before = derived_tables("SGAT", sg)
    runs.append(fit_counted(sg, cut_epoch(sg, SEQ_STEPS), scfg.n_layers,
                            "SGAT", (6 * scfg.n_layers, 0,
                                     2 * scfg.n_layers), route="captured",
                            card=card))
    check_fresh("SGAT", sg, before)
    g_cpu = g.to("cpu")
    step_card_vs_cpu("SGAT", sg, lambda p, *b: sgat_loss(g_cpu, p, scfg, *b),
                     first_batch(sg), None)
    models["SGAT"] = sg
    # the epoch as one program: the captured and the eager epoch from one
    # state, bit for bit; segsum among SGAT's replayed kernels
    for tag, kernel in (("FPMC", None), ("TransRec", None),
                        ("SGAT", "segsum")):
        epoch_routes(models[tag], tag, card, kernel)
    # Caser and HGN: towers over N + 1 columns
    cs = build("Caser")
    ccfg = cs.config
    require(ccfg.embed_size == DIM and (ccfg.seq_L, ccfg.seq_T, ccfg.nv,
                                        ccfg.nh) == (5, 3, 4, 16)
            and cs._eval_width == ITEMS + 1, "Caser at its defaults")
    runs.append(fit_counted(cs, cut_epoch(cs, SEQ_STEPS), 0, "Caser"))
    batch = first_batch(cs)
    keep = caser_keep_mask(torch.Generator(dev).manual_seed(SEED),
                           batch[0].shape[0], ccfg)
    step_card_vs_cpu(
        "Caser (dropout 0.5)", cs,
        lambda p, *b: caser_loss(p, ccfg, cs.pad_idx, *b), batch, keep)
    hg = build("HGN")
    require(hg.config.embed_size == DIM and hg._eval_width == ITEMS + 1,
            "HGN at its defaults")
    runs.append(fit_counted(hg, cut_epoch(hg, SEQ_STEPS), 0, "HGN"))
    step_card_vs_cpu("HGN", hg, lambda p, *b: hgn_loss(p, hg.pad_idx, *b),
                     first_batch(hg), None)
    models.update(Caser=cs, HGN=hg)
    # a lazy-Adam epoch each, cut to its first TRAIN_WINDOW steps: the
    # tables' gathered rows, the rest dense
    for name in ("Caser", "HGN"):
        lazy = build(name, optimizer="lazy_adam")
        lazy.pipeline.num_batches = TRAIN_WINDOW
        runs.append(fit_counted(lazy, TRAIN_WINDOW, 0,
                                f"{name} (lazy Adam)"))
        tables = lazy.optimizer.tables
        require(sorted(tables) == ["W2", "b2", "item_emb", "user_emb"]
                and all(t.grad is None for t in tables.values()),
                f"{name} (lazy Adam): no table gradient formed")
        models[f"{name} (lazy Adam)"] = lazy
    for tag, m in models.items():
        h = m.history[0]
        print(f"{tag} epoch: train {h['train_seconds']} s "
              f"({m.pipeline.num_batches / h['train_seconds']} steps/s of "
              f"batch {m.config.batch_size}), loss {h['loss']}, evaluate() "
              f"{h['eval_seconds']} s  [{card}]", flush=True)
    busy, heads = busy_share(lambda: epoch_window(sg), reps=1, warm=False,
                             top=8)
    print(f"SGAT train epoch, its first {TRAIN_WINDOW} of "
          f"{sg.pipeline.num_batches} steps: device busy {busy}; top device "
          f"kernels (ms, calls): {heads}  [{card}]", flush=True)
    # every route; the pad column of Caser and HGN included
    for tag, modes in (("FPMC", ("full", "fused", "chunked")),
                       ("TransRec", ("full", "chunked")),
                       ("SGAT", ("full", "chunked")),
                       ("Caser", ("full", "fused", "chunked")),
                       ("HGN", ("full", "fused", "chunked"))):
        route_runs = evaluate_routes(models[tag], tag, modes)
        runs.extend(r[2] for r in route_runs.values())
    # serving through predict: equal to the plain top-k, no seen item
    u = np.fromiter(sg.evaluator.user_pos_test, np.int64)[:B_EVAL]
    seen = sg.dataset.train_data.to_user_dict()
    for tag in ("FPMC", "TransRec", "SGAT", "Caser", "HGN"):
        server = TopKRecommender(models[tag], k=K)
        (ids, vals), launched = counted(lambda: server.recommend(u))
        check_served(server, u, ids, vals, seen)
        runs.append(launched)
    print(f"phase 12: recommend() for {len(u)} users of each model equals "
          f"the plain top-k; phase 12 took {time.perf_counter() - t_phase} "
          f"s", flush=True)
    return dict(models, runs=runs)

SERVE_KERNELS = {"predict": SERVING, "fused": FUSED + ("kth_largest",
                                                      "pruned_merge")}


def phase_sequence_towers(path, reg, dev, card: str, errs: dict):
    """Phase 13 (the module docstring): GRU4Rec, GRU4RecPlus, SASRec,
    BERT4Rec and SRGNN at Gowalla scale. Returns the models and the launch
    counts of each main-path run."""
    t_phase = time.perf_counter()

    def build(name, **over):
        reg.load_skrx_model(name)
        t0 = time.perf_counter()
        m = cut_eval(reg.get_model(name)[0](
            RunConfig(recommender=name, data_dir=path, seed=SEED),
            {"epochs": 1, "early_stop": 1, **over}))
        print(f"{name} built in {time.perf_counter() - t0} s", flush=True)
        return m
    models, runs, steps = {}, [], {}
    gen = torch.Generator(dev).manual_seed(SEED)
    # GRU4Rec and GRU4RecPlus: the session-parallel walk, B = 128 rows
    for name in ("GRU4Rec", "GRU4RecPlus"):
        m = build(name)
        cfg = m.config
        require(cfg.layers == [DIM] and cfg.batch_size == 128
                and cfg.loss == ("top1" if name == "GRU4Rec" else "bpr_max")
                and (name == "GRU4Rec" or cfg.n_sample == 2048)
                and m.item_emb.device == dev, f"{name} at its defaults")
        perm = np.random.default_rng((SEED, 0)).permutation(m._n_sessions)
        steps[name] = walker_num_steps(m._sess_lens, perm,
                                       cfg.batch_size)[1]
        # the epoch cut to a window of the walk
        m.step_limit = steps[name] = min(WALK_WINDOW, steps[name])
        runs.append(fit_counted(m, steps[name], 0, name))
        m.step_limit = None
        in_s, out_s, _ = m.epoch_schedule(0)
        states = [torch.randn((cfg.batch_size, n), device=dev, generator=gen)
                  for n in cfg.layers]
        neg = m.draw_negatives(gen)                 # None for GRU4Rec
        step_card_vs_cpu(
            name, m, lambda p, *b, m=m: gru4rec_loss(
                nest_params(p), m.config, m._loss_from_logits, *b)[0],
            (in_s[1], out_s[1], states, neg), None,
            card_step=lambda args, m=m: m.train_step(*args)[0])
        models[name] = m
    print(f"GRU4Rec walks: {steps} steps an epoch; the predict scan "
          f"{models['GRU4Rec']._pred_seq.shape[0]} steps over "
          f"{USERS} users", flush=True)
    # SASRec: one row a user, L = 50; a bf16 step besides the f32 ones
    sa = build("SASRec")
    scfg = sa.config
    require(scfg.hidden_units == DIM and scfg.max_len == 50
            and scfg.num_blocks == 2 and scfg.num_heads == 1
            and scfg.dropout_rate == 0.5 and scfg.batch_size == 128,
            "SASRec at its defaults")
    runs.append(fit_counted(sa, sa.pipeline.num_batches, 0, "SASRec"))
    batch = next(sa.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))
    draws = sasrec_draws(gen, batch[0].shape[0], scfg)
    step_card_vs_cpu("SASRec", sa, lambda p, *b: sasrec_loss(
        nest_params(p), scfg, sa.pad_id, *b[1:]), batch, draws,
        zero_grad_params={f"blocks.{i}.att.k.b": f"blocks.{i}.att.k.w"
                          for i in range(scfg.num_blocks)})
    models["SASRec"] = sa
    # BERT4Rec: windows of 5; its schedule past the warm-up for the
    # comparison (one epoch's schedule has decayed to 0 at its end)
    bt = build("BERT4Rec")
    bcfg = bt.config
    require((bcfg.max_seq_len, bcfg.h_size, bcfg.att_heads, bcfg.n_layers,
             bcfg.batch_size, bcfg.verbose) == (5, DIM, 2, 2, 256, 10)
            and bt.tok_emb.shape == (ITEMS + 2, DIM), "BERT4Rec at its "
            "defaults")
    bt.pipeline.num_batches = min(TOWER_STEPS, bt.pipeline.num_batches)
    runs.append(fit_counted(bt, bt.pipeline.num_batches, 0, "BERT4Rec"))
    bt.optimizer.count = 150
    batch = next(bt.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))
    draws = bert4rec_draws(gen, batch[0].shape[0], bcfg)
    opt = bt.optimizer
    step_card_vs_cpu(
        "BERT4Rec", bt, lambda p, *b: bert4rec_loss(
            nest_params(p), bcfg, ITEMS, *b), batch, draws,
        cpu_optimizer=lambda groups: OptaxAdamW(
            [{"params": g, "decay": og["decay"]}
             for g, og in zip(groups, opt.param_groups)], opt.schedule,
            opt.b1, opt.b2, opt.eps, opt.weight_decay, opt.max_norm),
        zero_grad_params={f"blocks.{i}.k.b": f"blocks.{i}.k.w"
                          for i in range(bcfg.n_layers)})
    models["BERT4Rec"] = bt
    # one bf16 step each, against the f32 loss of the same batch and draws
    for tag, m, draw, n_batch in (("SASRec", sa, sasrec_draws, 5),
                                  ("BERT4Rec", bt, bert4rec_draws, 2)):
        bb = next(m.pipeline.batches(epoch_generator(SEED + 8, 0, dev)))
        args = (*bb[:n_batch], draw(gen, bb[0].shape[0], m.config))
        with torch.no_grad():
            f32 = float(m._loss(*args))
        m.config.compute_dtype = "bfloat16"
        try:
            bf16 = float(m.train_step(args))
        finally:
            m.config.compute_dtype = "float32"
        finite = all(bool(torch.isfinite(p).all()) for p in m.parameters())
        print(f"{tag}: one bf16 step, loss {bf16} against f32 {f32}",
              flush=True)
        require(finite and abs(bf16 - f32) <= 0.05 * abs(f32),
                f"{tag} bf16 step: loss {bf16} vs f32 {f32}")
    # SRGNN: one example a prefix, sessions of up to 200 items
    sr = build("SRGNN")
    rcfg = sr.config
    require(rcfg.hidden_size == DIM and rcfg.step == 1
            and rcfg.max_seq_len == 200 and rcfg.batch_size == 256
            and sr.l_max == 200, "SRGNN at its defaults")
    print(f"SRGNN: {sr.num_examples} examples, {sr.num_batches} steps of "
          f"{rcfg.batch_size}, sessions (l_max, n_max) = ({sr.l_max}, "
          f"{sr.n_max})", flush=True)
    sr.num_batches = min(TOWER_STEPS, sr.num_batches)
    runs.append(fit_counted(sr, sr.num_batches, 0, "SRGNN"))
    batch = next(sr.batches(1))
    step_card_vs_cpu("SRGNN", sr, lambda p, *b: srgnn_loss(
        nest_params(p), rcfg, *(x.long() for x in b)), batch, None)
    models["SRGNN"] = sr
    for tag, m in models.items():
        h = m.history[0]
        n_steps = steps.get(tag) or getattr(m, "pipeline", m).num_batches
        print(f"{tag} epoch: train {h['train_seconds']} s ({n_steps} steps, "
              f"{n_steps / h['train_seconds']} steps/s of batch "
              f"{m.config.batch_size}), loss {h['loss']}, evaluate() "
              f"{h['eval_seconds']} s  [{card}]", flush=True)
        busy, heads = busy_share(lambda: epoch_window(m), reps=1,
                                 warm=False, top=6)
        print(f"{tag} train epoch, its first {TRAIN_WINDOW} steps: device "
              f"busy {busy}; top device kernels (ms, calls): {heads}  "
              f"[{card}]", flush=True)
    for tag, m in models.items():
        route_runs = evaluate_routes(m, tag, ("full", "fused", "chunked"))
        runs.extend(r[2] for r in route_runs.values())
    # serving through predict (GRU4Rec also fused): the plain top-k, no
    # seen item
    u = np.fromiter(sr.evaluator.user_pos_test, np.int64)[:B_EVAL]
    seen = sr.dataset.train_data.to_user_dict()
    for tag, m in models.items():
        server = TopKRecommender(m, k=K)
        (ids, vals), launched = counted(lambda: server.recommend(u))
        check_served(server, u, ids, vals, seen)
        runs.append(launched)
        for kname in SERVE_KERNELS["predict"]:
            require(launched[kname] >= 1,
                    f"{kname} never launched serving {tag}")
    fsrv = TopKRecommender(models["GRU4Rec"], k=K, fused="always")
    require(fsrv.fused, "GRU4Rec takes the fused route")
    answer, launched = counted(lambda: serve_measured(fsrv, u))
    check_fused_served(fsrv, *answer, seen)
    runs.append(launched)
    for kname in SERVE_KERNELS["fused"]:
        require(launched[kname] >= 1,
                f"{kname} never launched in GRU4Rec's fused serving")
    print(f"phase 13: recommend() for {len(u)} users of each model equals "
          f"the plain top-k (GRU4Rec's fused route too); phase 13 took "
          f"{time.perf_counter() - t_phase} s", flush=True)
    return dict(models, runs=runs)


def check_knn(tag, feats: np.ndarray, sims, ids, rng) -> dict:
    """The card's kNN selection (``sims``, ``ids`` (N, k)) of ``feats``
    against float64 on the CPU on KNN_ROWS sampled rows: a row's neighbour
    set may differ from the float64 top k only by neighbours whose float64
    similarity lies within 1e-5 of the row's k-th (near ties, which f32
    rounding may order either way); each selected similarity is within
    1e-5 of its float64 value."""
    n, k = ids.shape
    rows = np.sort(rng.choice(n, KNN_ROWS, replace=False))
    f64 = feats.astype(np.float64)
    norm = f64 / (np.linalg.norm(f64, axis=1, keepdims=True) + 1e-12)
    ref = norm[rows] @ norm.T                        # (rows, N) float64
    kth = -np.partition(-ref, k - 1, axis=1)[:, k - 1]
    pick = torch.as_tensor(rows, device=ids.device)
    got_ids, got_sims = ids[pick].cpu().numpy(), sims[pick].cpu().numpy()
    differ, gap, worst = 0, 0.0, 0.0
    for r in range(len(rows)):
        odd = set(np.flatnonzero(ref[r] >= kth[r]).tolist()) \
            ^ set(got_ids[r].tolist())
        differ += bool(odd)
        for item in odd:
            gap = max(gap, abs(ref[r, item] - kth[r]))
        worst = max(worst, float(np.abs(got_sims[r]
                                        - ref[r, got_ids[r]]).max()))
    require(gap <= 1e-5, f"{tag}: a neighbour {gap} from the k-th "
            f"similarity differs from float64's")
    require(worst <= 1e-5, f"{tag}: similarities off float64 by {worst}")
    return {"rows_differing": differ, "largest_gap_of_a_differing_"
            "neighbour": gap, "largest_similarity_error": worst}


def phase_multimodal(path, reg, dev, card: str, errs: dict):
    """Phase 14 (the module docstring): the item features, their kNN
    graphs and BM3, SLMRec, FREEDOM, MGCN and LATTICE at Gowalla scale.
    Returns the launch counts of each main-path run."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    synthetic.write_mm_features(path, ITEMS, SEED, IMG_DIM, TXT_DIM)
    data = RSDataset(path, "\t", "UIRT")
    feats = {"image": data.img_features, "text": data.txt_features}
    require(feats["image"].shape == (ITEMS, IMG_DIM)
            and feats["text"].shape == (ITEMS, TXT_DIM), "feature tables")
    print(f"item features {IMG_DIM} + {TXT_DIM} wide written and read in "
          f"{time.perf_counter() - t0} s", flush=True)
    rng = np.random.default_rng(SEED + 14)
    runs = []
    for tag, x in feats.items():
        x_dev = torch.as_tensor(x, device=dev)
        (sims, ids), launched = counted(lambda: knn_select(x_dev, KNN_K))
        (_, sec) = timed(lambda: knn_select(x_dev, KNN_K))
        for kname in SERVING:
            require(launched[kname] >= 1, f"{kname} never launched in the "
                    f"{tag} kNN selection")
        t0 = time.perf_counter()
        report = check_knn(tag, x, sims, ids, rng)
        print(f"kNN selection of the {tag} table ({ITEMS} x {x.shape[1]}, "
              f"k={KNN_K}): {sec} s on the card; launches {launched}; "
              f"against float64 on {KNN_ROWS} rows ({time.perf_counter() - t0}"
              f" s on the host): {report}  [{card}]", flush=True)
        del x_dev, sims, ids
    del feats, data

    def build(name, **want):
        reg.load_skrx_model(name)
        t0 = time.perf_counter()
        m, launched = counted(lambda: reg.get_model(name)[0](
            RunConfig(recommender=name, data_dir=path, seed=SEED),
            {"epochs": 1, "early_stop": 1}))
        cfg = m.config.to_dict()
        require(all(cfg[k] == v for k, v in want.items())
                and cfg["batch_size"] == 2048 and m.item_emb.device == dev,
                f"{name} at its defaults: {cfg}")
        print(f"{name} built in {time.perf_counter() - t0} s (its kNN "
              f"graphs included); launches {launched}", flush=True)
        runs.append(launched)
        m.pipeline.num_batches = min(MM_STEPS, m.pipeline.num_batches)
        return cut_eval(m)

    def first_batch(m):
        return next(m.pipeline.batches(epoch_generator(SEED + 7, 0, dev)))

    def finish(tag, m, props, modes, step, sums=(0, 0, 0), route=None):
        """fit(), one step card vs CPU, the evaluate() routes, serving and
        the epoch's reports of model m; with ``route`` "captured" also the
        derived tables after fit() and the two routes of an epoch."""
        t0 = time.perf_counter()
        before = derived_tables(tag, m) if route else None
        runs.append(fit_counted(m, m.pipeline.num_batches, props, tag,
                                sums, route, card))
        if route:
            check_fresh(tag, m, before)
        t1 = time.perf_counter()
        step()
        if route:
            epoch_routes(m, tag, card, "segsum")
        t2 = time.perf_counter()
        route_runs = evaluate_routes(m, tag, modes)
        runs.extend(r[2] for r in route_runs.values())
        u = np.fromiter(m.evaluator.user_pos_test, np.int64)[:B_EVAL]
        server = TopKRecommender(m, k=K)
        (ids, vals), launched = counted(lambda: server.recommend(u))
        check_served(server, u, ids, vals,
                     m.dataset.train_data.to_user_dict())
        runs.append(launched)
        for kname in SERVE_KERNELS["predict"]:
            require(launched[kname] >= 1,
                    f"{kname} never launched serving {tag}")
        h, steps = m.history[0], m.pipeline.num_batches
        print(f"{tag} epoch: train {h['train_seconds']} s ({steps} steps, "
              f"{steps / h['train_seconds']} steps/s of batch "
              f"{m.config.batch_size}), loss {h['loss']}, evaluate() "
              f"{h['eval_seconds']} s; recommend() for {len(u)} users "
              f"equals the plain top-k  [{card}]", flush=True)
        busy, heads = busy_share(lambda: epoch_window(m), reps=1,
                                 warm=False, top=6)
        print(f"{tag} train epoch, its first {TRAIN_WINDOW} steps: device "
              f"busy {busy}; top device kernels (ms, calls): {heads}  "
              f"[{card}]", flush=True)
        print(f"{tag}: fit() {t1 - t0} s, the step card vs CPU (and the "
              f"two routes of an epoch) {t2 - t1} s, the rest "
              f"{time.perf_counter() - t2} s", flush=True)

    def drop():
        """Free a model's device memory: the models hold reference cycles
        (their steps close over them), which only the collector frees."""
        gc.collect()
        torch.cuda.empty_cache()

    full3 = ("full", "fused", "chunked")
    # BM3: LightGCN over the SelfCF graph; table-wide target masks
    m = build("BM3", embed_dim=DIM, n_layers=1, dropout=0.3, cl_weight=2.0)
    cfg, g_cpu = m.config, m.graph.to("cpu")

    def bm3_step():
        batch = first_batch(m)
        draws = bm3_draws(torch.Generator(dev).manual_seed(SEED),
                          m.num_users, m.num_items, DIM, cfg.dropout,
                          m.has_t, m.has_v)
        step_card_vs_cpu("BM3", m, lambda p, u, i, w, d: bm3_loss(
            g_cpu, nest_params(p), cfg, u, i, w, d), batch, draws)
    finish("BM3", m, cfg.n_layers, full3, bm3_step, route="captured")
    del m, g_cpu
    drop()
    # SLMRec: three towers over one graph; a sigmoid score (no fused route)
    m = build("SLMRec", rec_dim=DIM, layer_num=3, ssl_task="FAC",
              mm_fusion_mode="concat", adj_type="pre")
    cfg, g_cpu = m.config, m.graph.to("cpu")
    v_cpu, t_cpu = m.v_feat.cpu(), m.t_feat.cpu()

    def slmrec_step():
        batch = first_batch(m)
        draws = slmrec_draws(torch.Generator(dev).manual_seed(SEED), cfg,
                             m.num_users + m.num_items)
        step_card_vs_cpu("SLMRec (FAC)", m, lambda p, u, i, w, d: slmrec_loss(
            g_cpu, nest_params(p), cfg, v_cpu, t_cpu, m.num_users, u, i, w,
            d), batch, draws)
    finish("SLMRec", m, 3 * cfg.layer_num, ("full", "chunked"), slmrec_step,
           route="captured")
    del m, g_cpu, v_cpu, t_cpu
    drop()
    # FREEDOM: the frozen kNN item graph and the pruned user-item graph
    m = build("FREEDOM", embed_dim=DIM, knn_k=KNN_K, n_mm_layers=1,
              n_ui_layers=2, mm_image_weight=0.1, dropout=0.8)
    cfg = m.config
    ui_cpu, mm_cpu = m.ui_graph.to("cpu"), m.mm_graph.to("cpu")

    def freedom_step():
        mask = m.epoch_mask(0)
        require(int((mask[:m.num_pairs] != 0).sum()) == m.keep_len,
                "FREEDOM keeps keep_len pairs")
        step_card_vs_cpu(f"FREEDOM ({m.keep_len} of {m.num_pairs} pairs "
                         f"kept)", m, lambda p, u, pos, neg, w, mask:
                         freedom_loss(ui_cpu, mm_cpu, nest_params(p), cfg, u,
                                      pos, neg, w, mask), first_batch(m),
                         mask)
    finish("FREEDOM", m, cfg.n_mm_layers + cfg.n_ui_layers, full3,
           freedom_step)
    del m, ui_cpu, mm_cpu
    drop()
    # MGCN: four graphs; the LambdaLR rate computed inside the step from
    # Adam's count, the schedule's steps an epoch those of the whole epoch
    m = build("MGCN", embed_dim=DIM, n_ui_layers=2, n_layers=1, knn_k=KNN_K,
              cl_loss=0.001)
    cfg = m.config
    graphs_cpu = MGCNGraphs(*(g.to("cpu") for g in m.graphs))
    require(m.steps_per_epoch > m.pipeline.num_batches,
            "MGCN's schedule keeps its whole epoch's steps")

    def mgcn_step():
        # the rate the card's step takes, which the CPU copy is given
        step_card_vs_cpu(
            f"MGCN (update {m.update_count}, lr "
            f"{float(m._flat_step.next_lr())})", m,
            lambda p, *b: mgcn_loss(graphs_cpu, nest_params(p), cfg, *b),
            first_batch(m), None)
    finish("MGCN", m, 2 * cfg.n_layers + 2 + cfg.n_ui_layers, full3,
           mgcn_step, route="captured")
    del m, graphs_cpu
    drop()
    # LATTICE: the learned item graph selected by blockwise_topk each epoch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m = build("LATTICE", embed_dim=DIM, knn_k=KNN_K, lambda_coeff=0.9,
              n_layers=1, cf_model="lightgcn", lr=1e-4)
    cfg = m.config

    def lattice_step():
        m.epoch_item, m.epoch_weights = m.item_graph(), None
        item = m.epoch_item
        item_cpu = lattice_item_graph(
            [i.cpu() for i in item.ids],
            [tuple(t.cpu() for t in o) for o in m.originals], m.num_items)
        ui_cpu = m.ui_graph.to("cpu")
        t0 = time.perf_counter()
        step_card_vs_cpu(
            f"LATTICE (the epoch's first step, {item.graph.graph.num_edges} "
            f"item edges with gradient)", m, lambda p, *b: lattice_loss(
                ui_cpu, item_cpu, nest_params(p), cfg, *b, None)[0],
            first_batch(m), None)
        print(f"LATTICE's step card vs CPU took {time.perf_counter() - t0} "
              f"s", flush=True)
        require(m.epoch_weights is not None
                and not m.epoch_weights.requires_grad,
                "LATTICE keeps the first step's weights, detached")
        m.epoch_item = m.epoch_weights = None
    runs_before = len(runs)
    # the learned graph's row sums: once an epoch (its first step) and once
    # an evaluation
    finish("LATTICE", m, cfg.n_layers + len(cfg.weight_size), full3,
           lattice_step, (0, 1, 1))
    require(runs[runs_before]["pruned_merge"] >= 1,
            "LATTICE's fit() selected its graph without blockwise_topk")
    peak = torch.cuda.max_memory_allocated() - base
    print(f"LATTICE peak device memory {peak / 2**30} GiB above the "
          f"{base / 2**30} GiB held before it (JAX's dense item graph: "
          f"{ITEMS * ITEMS * 4 / 2**30} GiB a matrix)  [{card}]", flush=True)
    del m
    drop()
    print(f"phase 14 took {time.perf_counter() - t_phase} s", flush=True)
    return {"runs": runs}


def _logged_report(log_path: str) -> dict:
    """The metric -> value of a fit()'s log: its "metrics:" names and its
    "best:" values."""
    names, values = None, None
    with open(log_path) as f:
        for line in f:
            cells = line.split()
            if cells[:1] == ["metrics:"]:
                names = cells[1:]
            elif cells[:1] == ["best:"]:
                values = [float(v) for v in cells[1:]]
    require(names is not None and values is not None
            and len(names) == len(values), f"no metrics in {log_path}")
    return dict(zip(names, values))


def _newest(pattern: str) -> str:
    found = sorted(glob.glob(pattern), key=os.path.getmtime)
    require(bool(found), f"no file matches {pattern}")
    return found[-1]


def phase_command_line(path, work: str, device=None) -> dict:
    """Phase 15 (the module docstring): the user's command line, its ini
    overlay and run options, a user model with a grid search, and no CPU
    fallback, run from the working directory ``work``. ``device`` is
    handed to the in-process runs (None: the card). Returns the launch
    counts of each main-path run."""
    t_phase = time.perf_counter()
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "run_skrx_torch.py")
    name = os.path.basename(os.path.normpath(path))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "unarchived_models"))
    cwd = os.getcwd()
    os.chdir(work)
    runs = []
    metrics = ("--top_k", "(10,20)", "--metric", "('Recall','NDCG')")
    argv = ["--recommender", "LightGCN", "--data_dir", path, "--epochs", "1",
            "--early_stop", "1", *metrics]
    try:
        # (a) the user's command
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, script, *argv], cwd=work,
                             capture_output=True, text=True, timeout=600)
        require(out.returncode == 0, f"run_skrx_torch.py exited "
                f"{out.returncode}: {out.stderr[-3000:]}")
        cli_log = _newest(os.path.join(work, "log", name, "LightGCN",
                                       "*.log"))
        logged = _logged_report(cli_log)
        print(f"phase 15 (a): python3 run_skrx_torch.py {' '.join(argv)} "
              f"exited 0 in {time.perf_counter() - t0} s; its log "
              f"{os.path.relpath(cli_log, work)}: {logged}", flush=True)
        # (b) the same argv in this process, and the model built by hand
        t0 = time.perf_counter()
        got, launches = counted(lambda: run_skrx_torch.main(argv, device))
        runs.append(launches)
        print(f"phase 15 (b): launches during run_skrx_torch.main(argv): "
              f"{launches} ({time.perf_counter() - t0} s)", flush=True)
        for kname in ("segsum", "submax", "kth_largest", "extract",
                      "rank_count"):
            require(launches[kname] > 0,
                    f"{kname} never launched by the command line's run")
        run_skrx_torch._set_random_seed(SEED)
        reg = ModelRegistry()
        reg.load_skrx_model("LightGCN")
        gcn_cls, _ = reg.get_model("LightGCN")
        direct = gcn_cls(RunConfig(recommender="LightGCN", data_dir=path,
                                   top_k=(10, 20),
                                   metric=("Recall", "NDCG")),
                         {"epochs": 1, "early_stop": 1}, device=device)
        require((direct.config.embed_size, direct.config.n_layers)
                == (DIM, 3), "LightGCN at full width")
        ref, launches = counted(direct.fit)
        runs.append(launches)
        del direct
        for key, value in ref.items():
            require(abs(got[key] - value) <= 1e-6
                    and abs(got[key] - logged[key]) <= 1e-6,
                    f"{key}: main() {got[key]}, subprocess {logged[key]}, "
                    f"by hand {value}")
        print(f"phase 15 (b): main() {dict(got.results)} equals the "
              f"subprocess's log and a LightGCN built by hand within 1e-6; "
              f"bit-equal to the one built by hand: "
              f"{dict(got.results) == dict(ref.results)}", flush=True)
        # (c) an ini file under the command line; compute_dtype routed
        t0 = time.perf_counter()
        ini = os.path.join(work, "run.ini")
        with open(ini, "w") as f:
            f.write(f"[run]\nrecommender = MultVAE\ndata_dir = {path}\n"
                    f"compute_dtype = bfloat16\nepochs = 1\n"
                    f"early_stop = 1\nlr = 0.005\n")
        vae, launches = counted(lambda: run_skrx_torch.main(
            ["--config", ini, "--lr", "0.002", *metrics], device))
        runs.append(launches)
        with open(_newest(os.path.join(work, "log", name, "MultVAE",
                                       "*.log"))) as f:
            text = f.read()
        require("compute_dtype=bfloat16" in text and "lr=0.002" in text
                and "lr=0.005" not in text,
                "the ini's compute_dtype and the CLI's lr in MultVAE's log")
        require(all(np.isfinite(v) for v in vae.values()),
                f"MultVAE metrics finite: {vae}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bpr, launches = counted(lambda: run_skrx_torch.main(
                ["--recommender", "BPRMF", "--data_dir", path,
                 "--compute_dtype", "bfloat16", "--epochs", "1",
                 "--early_stop", "1", *metrics], device))
        runs.append(launches)
        require(any("compute_dtype" in str(w.message) for w in caught),
                "BPRMF under --compute_dtype bfloat16 must warn")
        require(all(np.isfinite(v) for v in bpr.values()),
                f"BPRMF metrics finite: {bpr}")
        print(f"phase 15 (c): --config run.ini --lr 0.002: MultVAE ran "
              f"with compute_dtype=bfloat16 and lr=0.002 ({dict(vae.results)}"
              f"); BPRMF --compute_dtype bfloat16 warned and ran "
              f"({dict(bpr.results)}); {time.perf_counter() - t0} s",
              flush=True)
        # (d) a user model with a two-point grid, searched
        t0 = time.perf_counter()
        with open(os.path.join(work, "unarchived_models", "BPRMFGrid.py"),
                  "w") as f:
            f.write("from skrx_torch.models.BPRMF import BPRMF, "
                    "BPRMFConfig\n\n\n"
                    "class BPRMFGridConfig(BPRMFConfig):\n"
                    "    @classmethod\n"
                    "    def param_space(cls):\n"
                    "        return {'lr': [0.001, 0.01]}\n\n\n"
                    "class BPRMFGrid(BPRMF):\n"
                    "    pass\n")
        best, launches = counted(lambda: run_skrx_torch.main(
            ["--recommender", "BPRMFGrid", "--data_dir", path,
             "--hyperopt", "True", "--epochs", "1", "--early_stop", "1",
             *metrics], device))
        runs.append(launches)
        with open(_newest(os.path.join(work, "log", name, "BPRMFGrid",
                                       "hyperopt_*.log"))) as f:
            text = f.read()
        trials = [float(line.rsplit("NDCG@10=", 1)[1])
                  for line in text.splitlines() if line.startswith("trial ")]
        chosen = [line for line in text.splitlines()
                  if line.startswith("Best params:")]
        require(len(trials) == 2 and len(chosen) == 1
                and "lr" in chosen[0], f"the grid's log: {text[-2000:]}")
        require(abs(best["NDCG@10"] - max(trials)) <= 5e-7,
                f"returned NDCG@10 {best['NDCG@10']}, trials {trials}")
        print(f"phase 15 (d): BPRMFGrid from unarchived_models/, "
              f"--hyperopt True: grid fallback, trials NDCG@10 {trials}, "
              f"{chosen[0]!r}, returned {best['NDCG@10']}; "
              f"{time.perf_counter() - t0} s", flush=True)
        # (e) no fallback to the CPU
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, script, *argv], cwd=work,
                             capture_output=True, text=True, timeout=600,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        require(out.returncode != 0
                and "CUDA is not available" in out.stderr,
                f"without a card the command line must fail: rc "
                f"{out.returncode}, {out.stderr[-2000:]}")
        print(f"phase 15 (e): CUDA_VISIBLE_DEVICES=\"\" python3 "
              f"run_skrx_torch.py ... exited {out.returncode}: "
              f"{out.stderr.strip().splitlines()[-1]} "
              f"({time.perf_counter() - t0} s)", flush=True)
    finally:
        os.chdir(cwd)
    print(f"phase 15 took {time.perf_counter() - t_phase} s", flush=True)
    return {"runs": runs}


def _mesh_inputs(n_rows: int, dev):
    """Phase 16's seeded inputs on ``dev``: node features and a cotangent
    (n_rows, 64) for the propagate; user vectors (64, 64), an item table,
    a bias and a train table for the top-k."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = torch.randn(n_rows, DIM, generator=gen, device=dev)
    ct = torch.randn(n_rows, DIM, generator=gen, device=dev)
    uv = torch.randn(B_EVAL, DIM, generator=gen, device=dev) / 8
    items = torch.randn(ITEMS, DIM, generator=gen, device=dev) / 8
    bias = torch.randn(ITEMS, generator=gen, device=dev) / 8
    train = torch.randint(0, ITEMS + 1, (B_EVAL, 1456), generator=gen,
                          device=dev, dtype=torch.int32)
    return x, ct, uv, items, bias, train


def _mesh_fit_rank(m, steps: int) -> dict:
    """One fit() epoch of a model on a mesh, cut to ``steps`` and evaluated
    on EVAL_USERS test users; its launches counted, its whole parameters
    on rank 0."""
    cut_epoch(m, steps)
    cut_eval(m)
    best, launches = counted(m.fit)
    whole = {k: v.cpu().numpy() for k, v in m.full_params().items()}
    h = m.history[0]
    return {"loss": h["loss"], "train_seconds": h["train_seconds"],
            "eval_seconds": h["eval_seconds"], "report": dict(best.results),
            "launches": launches, "mode": m.evaluator.eval_mode,
            "params": whole if m.mesh.rank == 0 else None}


def _mesh_pair_rank(rank: int, path: str, adj_path: str, work: str,
                    device: str, depth: dict) -> dict:
    """Phase 16 (a)-(d) on one of 2 ranks sharing ``device`` at the
    spawning process's ``depth`` (a spawned rank imports this module
    anew)."""
    globals().update(depth)
    import scipy.sparse as sp
    import torch.distributed as dist
    dev = torch.device(device)
    out = {"world": dist.get_world_size(), "device": str(dev),
           "backend": dist.get_backend()}
    mesh = make_mesh((1, 2), dev)
    # (b) the sharded propagate, forward and backward, on this rank's rows
    g = ShardedPropGraph(mesh, sp.load_npz(adj_path), device=dev)
    x, ct, uv, items, bias, train = _mesh_inputs(g.num_nodes, dev)
    rows = slice(rank * g.rows_per_shard, (rank + 1) * g.rows_per_shard)
    xl = pad_rows(x, g.graph)[rows].clone().requires_grad_()

    def prop():
        y = propagate(g, xl)
        torch.sum(y * pad_rows(ct, g.graph)[rows]).backward()
        return y
    y, out["prop_launches"] = counted(prop)
    out["prop"] = (y.detach().cpu().numpy(), xl.grad.cpu().numpy())
    # (c) the two-stage top-k over the split catalog
    (vals, ids), out["topk_launches"] = counted(lambda: sharded_dot_topk(
        mesh, uv, items, bias, K_EVAL, ITEMS, train))
    out["topk"] = (vals.cpu().numpy(), ids.cpu().numpy())
    # (d) LightGCN on (1, 2)
    os.chdir(work)
    reg = ModelRegistry()
    reg.load_skrx_model("LightGCN")
    gcn = reg.get_model("LightGCN")[0](
        RunConfig(recommender="LightGCN", data_dir=path, seed=SEED,
                  mesh_shape=(1, 2)),
        {"batch_size": 2048, "epochs": 1, "early_stop": 1}, device=dev)
    out["gcn"] = _mesh_fit_rank(gcn, MESH_GCN_STEPS)
    return out


def _mesh_quad_rank(rank: int, path: str, work: str, device: str,
                    depth: dict) -> dict:
    """Phase 16 (e): BPRMF on one of 4 ranks sharing ``device`` at the
    spawning process's ``depth``."""
    globals().update(depth)
    os.chdir(work)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    bpr = reg.get_model("BPRMF")[0](
        RunConfig(recommender="BPRMF", data_dir=path, seed=SEED,
                  mesh_shape=(2, 2)),
        {"epochs": 1, "early_stop": 1}, device=device)
    return {"bpr": _mesh_fit_rank(bpr, MESH_BPR_STEPS), "tp": bpr._tp}


def _mesh_against_single(tag: str, ranks, single, single_report,
                         single_loss: float, on_card: bool) -> None:
    """Phase 16 (d), (e): each rank's epoch loss within 1e-5 relative of
    the single device's, every parameter row within 1e-5 of its table's
    scale, the "topk" metrics within 1e-4 of the single device's "full"
    (and, on the card, the launches of the "topk" route)."""
    whole = ranks[0]["params"]
    worst = {}
    for name, p in single.named_parameters():
        ref = p.detach().cpu().numpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(whole[name] - ref).max())
        worst[name] = err / scale
        require(err <= 1e-5 * scale, f"{tag} {name}: off by {err} (table "
                f"scale {scale})")
    for r in ranks:
        require(r["mode"] == "auto" and abs(r["loss"] - single_loss)
                <= 1e-5 * abs(single_loss),
                f"{tag} loss {r['loss']} against {single_loss}")
        # "auto" took the two-stage top-k: the rank counts never ran
        require(not on_card or r["launches"]["rank_count"]
                == r["launches"]["direct_rank"] == 0
                and r["launches"]["vmem_topk"] >= 1,
                f"{tag}: evaluate() did not go through 'topk': "
                f"{r['launches']}")
        for key, value in single_report.items():
            require(abs(r["report"][key] - value) <= 1e-4,
                    f"{tag} {key}: topk {r['report'][key]}, full {value}")
    print(f"phase 16 {tag}: loss {ranks[0]['loss']} (one device "
          f"{single_loss}); parameters off by at most {worst} of each "
          f"table's scale; evaluate() through 'topk' {ranks[0]['report']} "
          f"(one device's 'full' {dict(single_report.results)}); within 1e-4",
          flush=True)


def phase_mesh(path, work: str, card: str, device=None) -> dict:
    """Phase 16 (the module docstring): the mesh, ranks sharing the card
    (``device``, None: cuda:0, also each rank's). Returns the launch
    counts of each main-path run (the single device's and each rank's)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = dev.type == "cuda"       # a CPU rehearsal launches nothing
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    reg = ModelRegistry()
    reg.load_skrx_model("LightGCN")
    reg.load_skrx_model("BPRMF")
    try:
        # the single device: LightGCN (it writes the adjacency the ranks
        # read), the propagate and the top-k, and one cut fit() epoch
        gcn = cut_eval(reg.get_model("LightGCN")[0](
            RunConfig(recommender="LightGCN", data_dir=path, seed=SEED),
            {"batch_size": 2048, "epochs": 1, "early_stop": 1}, device=dev))
        require((gcn.config.embed_size, gcn.config.n_layers) == (DIM, 3),
                "LightGCN at full width")
        x, ct, uv, items, bias, train = _mesh_inputs(gcn.graph.num_nodes,
                                                     dev)
        x.requires_grad_()
        y_ref = propagate(gcn.graph, x)
        torch.sum(y_ref * ct).backward()
        ref_v, ref_i = metrics.topk_scores_and_indices(
            uv @ items.T + bias[None, :], K_EVAL, mask_table=train)
        gcn_steps = cut_epoch(gcn, MESH_GCN_STEPS)
        _, gcn_launches = counted(gcn.fit)
        adj_path = os.path.join(path, "_LightGCN_data", "pre_adj.npz")
        t0 = time.perf_counter()
        pair = run_ranks(_mesh_pair_rank, 2,
                         (path, adj_path, work, str(dev), depth()),
                         device=dev, timeout=600)
        pair_s = time.perf_counter() - t0
        # (a) the backend
        for r, o in enumerate(pair):
            print(f"phase 16 (a): rank {r} of {o['world']} on {o['device']},"
                  f" backend {o['backend']}", flush=True)
            require(o["backend"] == "gloo" and o["world"] == 2,
                    "2 ranks sharing one card run gloo")
        # (b) the sharded propagate against the single device
        y = torch.from_numpy(np.concatenate([o["prop"][0] for o in pair]))
        dx = torch.from_numpy(np.concatenate([o["prop"][1] for o in pair]))
        n = gcn.graph.num_nodes
        errs16 = {}
        for tag, got, ref in (("A x", y[:n], y_ref.detach()),
                              ("A^T g", dx[:n], x.grad)):
            ref = ref.cpu()
            scale = float(ref.abs().max())
            errs16[tag] = float((got - ref).abs().max())
            require(errs16[tag] <= 1e-5 * scale,
                    f"sharded {tag} off by {errs16[tag]} (scale {scale})")
        for r, o in enumerate(pair):
            require(not on_card or o["prop_launches"]["segsum"] == 2,
                    f"rank {r}: segsum {o['prop_launches']['segsum']} "
                    f"launches for one propagate and its gradient, not 2")
        print(f"phase 16 (b): sharded propagate on the LightGCN graph "
              f"({n} rows, {gcn.graph.num_edges} edges, D={DIM}, "
              f"{pair[0]['prop'][0].shape[0]} rows a rank) against one "
              f"device: max |err| {errs16} (within 1e-5 of the output's "
              f"scale); segsum launches per rank "
              f"{[o['prop_launches']['segsum'] for o in pair]} (one "
              f"forward, one backward)", flush=True)
        # (c) the two-stage top-k against the single device's
        got_v, got_i = (torch.from_numpy(a) for a in pair[0]["topk"])
        require(all(np.array_equal(o["topk"][1], pair[0]["topk"][1])
                    for o in pair), "the ranks' merged top-k differ")
        ref_v, ref_i = ref_v.cpu(), ref_i.cpu()
        scale = float(ref_v.abs().max())
        verr = float((got_v - ref_v).abs().max())
        require(verr <= 1e-5 * scale, f"top-k values off by {verr}")
        ties = 0
        for row in range(B_EVAL):
            if torch.equal(got_i[row], ref_i[row]):
                continue
            # a different id only at a near tie around the k-th value
            kth = float(ref_v[row, -1])
            diff = got_i[row] != ref_i[row]
            near = (ref_v[row][diff] - kth).abs().max()
            require(float(near) <= 1e-5 * scale,
                    f"top-k row {row} differs beyond a near tie")
            ties += 1
        for r, o in enumerate(pair):
            for kname in SERVING + ("vmem_topk",):
                require(not on_card or o["topk_launches"][kname] >= 1,
                        f"rank {r}: {kname} not launched by the top-k")
        print(f"phase 16 (c): sharded_dot_topk (B={B_EVAL}, k={K_EVAL}, "
              f"d={DIM}, {ITEMS} items, 2 shards of {-(-ITEMS // 2)}, "
              f"train table) against one device: values within {verr} "
              f"(scale {scale}); {ties} rows with a near tie at the k-th "
              f"place; launches per rank "
              f"{[o['topk_launches'] for o in pair]}", flush=True)
        # (d) LightGCN on (1, 2) against one device
        gcn_one = gcn.history[0]
        _mesh_against_single("(d) LightGCN (1, 2)",
                             [o["gcn"] for o in pair], gcn,
                             gcn_one["report"], gcn_one["loss"], on_card)
        expect = gcn_steps * 2 * 3 + 3
        for r, o in enumerate(pair):
            got = o["gcn"]["launches"]
            require(not on_card or got["segsum"] == expect,
                    f"rank {r}: segsum {got['segsum']} launches, not "
                    f"{expect}")
            for kname in SERVING + ("vmem_topk",):
                require(not on_card or got[kname] >= 1,
                        f"rank {r}: {kname} never launched in LightGCN's "
                        f"sharded fit()")
            print(f"phase 16 (d): rank {r} launches in fit() "
                  f"({gcn_steps} steps + evaluate()): {got}; "
                  f"segsum expected {expect}", flush=True)
        del gcn
        # (e) BPRMF on (2, 2)
        bpr = cut_eval(reg.get_model("BPRMF")[0](
            RunConfig(recommender="BPRMF", data_dir=path, seed=SEED),
            {"epochs": 1, "early_stop": 1}, device=dev))
        bpr_steps = cut_epoch(bpr, MESH_BPR_STEPS)
        _, bpr_launches = counted(bpr.fit)
        t0 = time.perf_counter()
        quad = run_ranks(_mesh_quad_rank, 4,
                         (path, work, str(dev), depth()), device=dev,
                         timeout=600)
        quad_s = time.perf_counter() - t0
        require(all(o["tp"] for o in quad), "BPRMF's tensor-parallel step")
        bpr_one = bpr.history[0]
        _mesh_against_single("(e) BPRMF (2, 2)", [o["bpr"] for o in quad],
                             bpr, bpr_one["report"], bpr_one["loss"],
                             on_card)
        for r, o in enumerate(quad):
            for kname in SERVING + ("vmem_topk",):
                require(not on_card or o["bpr"]["launches"][kname] >= 1,
                        f"rank {r}: {kname} never launched in BPRMF's "
                        f"sharded fit()")
        print(f"phase 16 (e): launches per rank in fit() "
              f"({bpr_steps} steps + evaluate()): "
              f"{[o['bpr']['launches'] for o in quad]}", flush=True)
        del bpr
        # (f) the user's command under torchrun
        t0 = time.perf_counter()
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "run_skrx_torch.py")
        cli = os.path.join(work, "cli")
        os.makedirs(cli)
        argv = ["--recommender", "LightGCN", "--data_dir", path,
                "--mesh_shape", "(1,2)", "--epochs", "1", "--early_stop",
                "1", "--batch_size", str(MESH_CLI_BATCH), "--top_k",
                "(10,20)", "--metric", "('Recall','NDCG')"]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", script, *argv]
        done = subprocess.run(cmd, cwd=cli, capture_output=True, text=True,
                              timeout=600)
        require(done.returncode == 0, f"torchrun exited {done.returncode}: "
                f"{done.stderr[-3000:]}")
        name = os.path.basename(os.path.normpath(path))
        logs = glob.glob(os.path.join(cli, "log", "*", "*", "*.log"))
        require(len(logs) == 1 and os.path.dirname(logs[0]) == os.path.join(
            cli, "log", name, "LightGCN"), f"one log, rank 0's: {logs}")
        logged = _logged_report(logs[0])
        require(all(np.isfinite(v) for v in logged.values()),
                f"finite metrics in the log: {logged}")
        cli_s = time.perf_counter() - t0
        print(f"phase 16 (f): torchrun --standalone --nproc_per_node 2 "
              f"run_skrx_torch.py {' '.join(argv)} exited 0 in {cli_s} s "
              f"(2 ranks sharing one H100); one log, rank 0's: {logged}",
              flush=True)
    finally:
        os.chdir(cwd)
    # (g) seconds, every one of them taken by ranks sharing one card
    print(f"phase 16 (g) [{card}]: LightGCN (1, 2), 2 ranks sharing one "
          f"H100: {gcn_steps} steps in "
          f"{pair[0]['gcn']['train_seconds']} s, "
          f"{pair[0]['gcn']['train_seconds'] / gcn_steps} s a step "
          f"(one device: {gcn_one['train_seconds']} s, "
          f"{gcn_one['train_seconds'] / gcn_steps} s a step); its "
          f"'topk' evaluate() {pair[0]['gcn']['eval_seconds']} s (one "
          f"device's 'full' {gcn_one['eval_seconds']} s); the 2 ranks' "
          f"call {pair_s} s. BPRMF (2, 2), 4 ranks sharing one H100: "
          f"{bpr_steps} steps in {quad[0]['bpr']['train_seconds']} s "
          f"(one device {bpr_one['train_seconds']} s), 'topk' evaluate() "
          f"{quad[0]['bpr']['eval_seconds']} s (one device's 'full' "
          f"{bpr_one['eval_seconds']} s); the 4 ranks' call {quad_s} s. "
          f"The command (f) {cli_s} s. Phase 16 took "
          f"{time.perf_counter() - t_phase} s", flush=True)
    return {"runs": [gcn_launches, bpr_launches]
            + [o["gcn"]["launches"] for o in pair]
            + [o["bpr"]["launches"] for o in quad]}


def _p17_model(name: str, path: str, dev, mesh_shape=None):
    """Model ``name`` at its default widths for phase 17: one cut epoch,
    evaluated through P17_EVAL_USERS test users in batches of 256."""
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    cls = reg.get_model(name)[0]
    m = cls(RunConfig(recommender=name, data_dir=path, seed=SEED,
                      test_batch_size=256, mesh_shape=mesh_shape),
            {"epochs": 1, "early_stop": 1, **P17_CONFIG.get(name, {})},
            device=dev)
    test = m.evaluator.user_pos_test
    m.evaluator.set_test_data({u: test[u] for u in
                               sorted(test)[:P17_EVAL_USERS]})
    if name == "SASRec":
        # its query mask, sign(|sum(LN(x))|), reads a sum that is 0 but for
        # rounding while the layer norms keep their initial bias 0: a
        # rank's 64 rows and one device's 128 reduce in other orders and
        # mask other positions. Biases from a seed (both runs alike)
        gen = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for key, p in m.named_parameters():
                if key.rsplit(".", 1)[-1].startswith("ln") \
                        and key.endswith("_b"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return m, cut_epoch(m, P17_FEW.get(name, P17_STEPS))


def _p17_noise(name: str, m) -> set:
    """The parameters of ``m`` of exactly zero gradient (P17_NOISE)."""
    blocks = len(getattr(m, "blocks", ()))
    return {n.format(i) for n in P17_NOISE.get(name, ())
            for i in range(max(blocks, 1))}


def _p17_topk(m) -> dict:
    """predict_topk over P17_TOPK_USERS users against the masked top-k of
    predict (every rank of the model group calls it): the value error, the
    greatest gap between an id's place and predict's score of it (an id
    may differ at a near tie), their scale (the largest finite |score| of
    the rows: the magnitude the two routes round at), the rows that
    differ, and the launches. Checked in the main process."""
    users = np.arange(P17_TOPK_USERS)
    width = getattr(m, "_eval_width", None) or m.num_items
    train = torch.as_tensor(m.evaluator._tables_for(users, width)[0]).to(
        m.device)
    (vals, ids), launches = counted(
        lambda: m.predict_topk(users, K_EVAL, train))
    scores = metrics.mask_items(torch.as_tensor(m.predict(users)).float(),
                                train)
    ref_v, ref_i = metrics.topk_scores_and_indices(scores, K_EVAL)
    finite = torch.isfinite(ref_v)
    scale = float(scores[torch.isfinite(scores)].abs().max())
    err = float((vals - ref_v)[finite].abs().max())
    picked = torch.gather(scores, 1, ids.long().clamp(0, scores.shape[1]
                                                      - 1))
    diff = (ids != ref_i) & finite
    near = float((picked - ref_v)[diff].abs().max()) if bool(diff.any()) \
        else 0.0
    return {"err": err, "near": near, "scale": scale,
            "ties": int(diff.any(dim=1).sum()), "launches": launches}


def _p17_gaps(whole: dict, one, noise: set):
    """(worst by 2-norm, worst entry, the zero-gradient biases' entry
    gaps) of the whole parameters ``whole`` against model ``one``'s."""
    gaps, norms = {}, {}
    for key, p in one.named_parameters():
        ref = p.detach().float()
        delta = whole[key].float() - ref
        gaps[key] = float(delta.abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        norms[key] = float(torch.linalg.vector_norm(delta)) / max(
            float(torch.linalg.vector_norm(ref)), 1e-30)
    kept = [k for k in gaps if k not in noise]
    worst = max(kept, key=norms.get, default=None)
    entry = max(kept, key=gaps.get, default=None)
    return ((worst, norms.get(worst, 0.0)), (entry, gaps.get(entry, 0.0)),
            {k: gaps[k] for k in noise if k in gaps})


def _p17_single(name: str, path: str, dev, whole: dict) -> dict:
    """Model ``name``'s same cut epoch on one device, its gaps to the mesh
    model's whole parameters ``whole``; for P17_TWICE whether a second run
    gives the same bits (and its gap), for P17_REORDER a third run's gap
    with each step's batch in reverse order (P17_ORDER_MULT)."""
    t0 = time.perf_counter()
    one, _ = _p17_model(name, path, dev)
    out = {"single_build_seconds": time.perf_counter() - t0}
    one_best, out["single_launches"] = counted(one.fit)
    h1 = one.history[0]
    noise = _p17_noise(name, one)
    out["gap"], out["entry_gap"], out["noise_gaps"] = _p17_gaps(whole, one,
                                                                noise)
    out.update(single_loss=h1["loss"], single_seconds=h1["train_seconds"],
               single_report=dict(one_best.results))
    first = {k: p.detach().clone() for k, p in one.named_parameters()}
    del one
    if name in P17_TWICE:
        again, _ = _p17_model(name, path, dev)
        again.fit()
        out["twice_gap"] = _p17_gaps(first, again, noise)[0]
        out["twice_equal"] = again.history[0]["loss"] == h1["loss"] and all(
            same_bits(p.detach(), first[k])
            for k, p in again.named_parameters())
        del again
    if name in P17_REORDER:
        other, _ = _p17_model(name, path, dev)
        other.lanes_reversed = other.rows_reversed = True
        other.fit()
        out["reorder_gap"] = _p17_gaps(first, other, noise)[0]
        out["reorder_loss"] = other.history[0]["loss"]
        del other
    return out


def _p17_rank(rank: int, path: str, work: str, device: str,
              depth: dict) -> dict:
    """Phase 17 on one of 4 ranks sharing ``device``: every model of
    P17_MODELS on (2, 2); then, all ranks at once, the same steps on one
    device of the models whose index is the rank's modulo 4, against the
    whole parameters the rank kept. ``depth``: the spawning process's
    depth settings (a spawned rank imports this module anew)."""
    import torch.distributed as dist
    globals().update(depth)
    os.chdir(work)
    dev = torch.device(device)
    out, kept = {}, {}
    for i, name in enumerate(P17_MODELS):
        dist.barrier()
        t0 = time.perf_counter()
        m, steps = _p17_model(name, path, dev, (2, 2))
        t_build = time.perf_counter() - t0
        best, launches = counted(m.fit)
        h = m.history[0]
        out[name] = {"steps": steps, "loss": h["loss"],
                     "build_seconds": t_build,
                     "train_seconds": h["train_seconds"],
                     "eval_seconds": h["eval_seconds"],
                     "report": dict(best.results), "launches": launches,
                     "mode": m.evaluator.eval_mode}
        if hasattr(m, "predict_topk"):
            out[name]["topk"] = _p17_topk(m)
        whole = m.full_params()
        if i % 4 == rank:
            kept[name] = whole
        del m, whole
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    for name, whole in kept.items():
        out[name].update(_p17_single(name, path, dev, whole))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def phase_mesh_models(path, work: str, card: str, device=None) -> dict:
    """Phase 17 (the module docstring): every other model on (2, 2), 4
    ranks sharing the card (``device``, None: cuda:0). Returns the launch
    counts of each main-path run (each rank's and rank 0's single
    device's, each model's fit() and predict_topk)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = dev.type == "cuda"       # a CPU rehearsal launches nothing
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ranks = run_ranks(_p17_rank, 4, (path, work, str(dev), depth()),
                      device=dev,
                      timeout=1000)
    runs, failed = [], []

    def check(ok: bool, what: str) -> None:
        # every model's line is printed first; the phase then fails on
        # the whole list
        if not ok:
            failed.append(what)
    for i, name in enumerate(P17_MODELS):
        per = [r[name] for r in ranks]
        one = per[i % 4]                 # the rank that ran one device
        loss_bound = gap_bound = 1e-4
        if name in P17_REORDER:         # calibrated in this run
            gap_bound = max(gap_bound,
                            P17_ORDER_MULT * one["reorder_gap"][1])
            loss_bound = max(loss_bound, P17_ORDER_MULT * abs(
                one["reorder_loss"] - one["single_loss"])
                / abs(one["single_loss"]))
        for r, o in enumerate(per):
            runs.append(o["launches"])
            check(abs(o["loss"] - one["single_loss"])
                  <= loss_bound * abs(one["single_loss"])
                  if one["single_loss"] is not None else o["loss"] is None,
                  f"phase 17 {name} rank {r}: loss {o['loss']}, one "
                  f"device {one['single_loss']} (bound {loss_bound} "
                  f"relative)")
            for key, value in one["single_report"].items():
                check(abs(o["report"][key] - value) <= 1e-4,
                      f"phase 17 {name} rank {r} {key}: mesh "
                      f"{o['report'][key]}, one device {value}")
            if "topk" in o:
                t = o["topk"]
                runs.append(t["launches"])
                # values within 1e-5 of the scores' scale; an id differs
                # only where predict scores it as near its place's value
                check(max(t["err"], t["near"]) <= 1e-5 * t["scale"],
                      f"phase 17 {name} rank {r}: predict_topk values "
                      f"off by {t['err']}, an id {t['near']} off its "
                      f"place (scale {t['scale']})")
                check(o["mode"] == "auto" and (
                    not on_card or o["launches"]["rank_count"]
                    == o["launches"]["direct_rank"] == 0),
                    f"phase 17 {name} rank {r}: evaluate() did not go "
                    f"through 'topk': {o['launches']}")
                for kname in SERVING + ("vmem_topk",):
                    check(not on_card or t["launches"][kname] >= 1,
                          f"phase 17 {name} rank {r}: {kname} never "
                          f"launched by predict_topk")
            if name in P17_GRAPH:
                check(not on_card or o["launches"]["segsum"] >= 1,
                      f"phase 17 {name} rank {r}: segsum never launched "
                      f"in its sharded fit()")
        runs.append(one["single_launches"])
        key, gap = one["gap"]
        check(gap <= gap_bound, f"phase 17 {name}: {key} off by {gap} of "
              f"its norm (bound {gap_bound})")
        if name in P17_TWICE:
            check(one["twice_equal"], f"phase 17 {name}: one device run "
                  f"twice is not bit-equal ({one['twice_gap']})")
        metric_gap = max((abs(one["report"][k] - v) for k, v in
                          one["single_report"].items()), default=0.0)
        steps = max(one["steps"], 1)
        topk = one.get("topk")
        twice = one.get("twice_gap")
        print(f"phase 17 {name} [{card}]: {one['steps']} steps on (2, 2), "
              f"4 ranks sharing one H100: {one['train_seconds'] / steps} s "
              f"a step (one device {one['single_seconds'] / steps} s); "
              f"loss {one['loss']} (one device {one['single_loss']}); "
              f"greatest parameter gap {gap} of its norm ({key}), greatest "
              f"entry gap {one['entry_gap'][1]} of its table's scale "
              f"({one['entry_gap'][0]})"
              + (f", zero-gradient biases {one['noise_gaps']}"
                 if one["noise_gaps"] else "")
              + (f"; one device run twice: bit-equal {one['twice_equal']}"
                 f", {twice[1]} of its norm ({twice[0]})" if twice else "")
              + (f"; one device with each step's batch reversed: "
                 f"{one['reorder_gap'][1]} of its norm "
                 f"({one['reorder_gap'][0]}), loss {one['reorder_loss']}; "
                 f"bounds {gap_bound} of a norm, {loss_bound} of the loss"
                 if name in P17_REORDER else "")
              + f"; 'topk' evaluate() of {P17_EVAL_USERS} users "
              f"{one['eval_seconds']} s, metric gap {metric_gap}"
              + (f"; predict_topk of {P17_TOPK_USERS} users within "
                 f"{topk['err']} (scale {topk['scale']}, {topk['ties']} "
                 f"rows with a near tie, {topk['near']} apart)"
                 if topk else "")
              + f"; built in {one['build_seconds']} s on the mesh, "
              f"{one['single_build_seconds']} s on one device; rank "
              f"{i % 4} launches {one['launches']}", flush=True)
    require(not failed, "\n".join(failed))
    print(f"phase 17 launches, every rank's and one device's summed: "
          f"{ {k: sum(r[k] for r in runs) for k in runtime.KERNELS} }",
          flush=True)
    print(f"phase 17 [{card}]: {len(P17_MODELS)} models on (2, 2) in "
          f"{time.perf_counter() - t_phase} s", flush=True)
    return {"runs": runs}


def _longrun_script():
    """``scripts/longrun_torch.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "longrun_torch", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts", "longrun_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_longrun(work: str, card: str, device=None) -> dict:
    """Phase 18 (the module docstring): the long-run sweep's ten models at
    P18's widths and cuts, against the JAX reference at the same cut.
    Returns each run's launches (``runs``) and records."""
    t_phase = time.perf_counter()
    lr = _longrun_script()
    ref = lr.load_reference()
    require(ref is not None, "experiments/longrun_reference.json missing")
    dev = device if device is not None else torch.device("cuda", 0)
    shutil.rmtree(work, ignore_errors=True)
    data = lr.make_data(work)
    runs, records = [], {}
    for name, hp, _ in lr.SWEEP:
        widths, e = P18[name]
        rec = lr.run_model(name, hp, e, data, SEED, dev, widths)
        runs.append(rec["launches"])
        records[name] = rec
        band = lr.band_at(ref, widths, name, e)
        require(band is not None, f"{name}: no JAX band at {e} epochs")
        mu, _, lo, hi = band
        best = lr.best_through(rec["curve"], e)
        require(rec["ran_epochs"] == e and not rec["loss_nan"],
                f"{name}: {rec['ran_epochs']} of {e} epochs, NaN loss "
                f"{rec['loss_nan']}")
        if widths == "sweep":
            require(lo <= best <= hi,
                    f"{name}: best NDCG@10 {best} through {e} epochs "
                    f"outside JAX's [{lo}, {hi}] (mean of its seeds {mu})")
            against = f"JAX's seeds [{lo}, {hi}], mean {mu}"
        else:
            against = (f"at its defaults, not held to JAX's one seed's "
                       f"{mu}")
        launches = rec["launches"]
        ranks = sum(launches[k] for k in ("direct_rank", "rank_count",
                                          "rank_lookup_count"))
        require(ranks >= len(rec["curve"]),
                f"{name}: {ranks} rank-kernel launches for "
                f"{len(rec['curve'])} evaluations")
        if name in ("LightGCN", "LightGCL", "BM3"):
            require(launches["segsum"] > 0, f"{name}: segsum never launched")
        print(f"phase 18 {name}: best NDCG@10 {best} at epoch "
              f"{rec['best_epoch']} of {e} ({against}); "
              f"{rec['seconds_per_epoch']} s an epoch; launches "
              f"{dict((k, v) for k, v in launches.items() if v)}  [{card}]",
              flush=True)
    for name, hp, _ in lr.SWEEP:
        if name not in P18_TWICE:
            continue
        widths, e = P18[name]
        again = lr.run_model(name, hp, e, data, SEED, dev, widths)
        runs.append(again["launches"])
        first = records[name]
        gap = max(abs(a[1] - b[1]) for a, b in zip(first["curve"],
                                                   again["curve"]))
        print(f"phase 18 {name} run twice from seed {SEED}: best NDCG@10 "
              f"{first['best']} and {again['best']} (gap "
              f"{abs(first['best'] - again['best'])}; the largest gap of "
              f"an epoch's NDCG@10 {gap})  [{card}]", flush=True)
        require(gap == 0.0, f"phase 18 {name}: two runs from one seed "
                f"differ, by {gap} of an epoch's NDCG@10")
    print(f"phase 18 took {time.perf_counter() - t_phase} s", flush=True)
    return {"runs": runs, "records": records}


def main(skip=()) -> int:
    """The whole run; the phases in ``skip`` (13-18) left out, as
    experiments/chip_phase9.py runs it."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    t_main = time.perf_counter()
    marks = [("1", t_main)]           # (phase, when it began)

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))
        print(f"[{marks[-1][1] - t_main:.1f} s] phase {phase}", flush=True)
    dev = torch.device("cuda", 0)
    card = card_line()
    # the bounds take this card's data-sheet rates; an unknown card raises
    global F32_OPS, MEM_RATE
    name, (_, F32_OPS, MEM_RATE) = chip_peaks(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "f32 matmuls must run without TF32")
    t0 = time.perf_counter()
    _build.load("segsum")
    info = _build.build_info()
    print(f"kernels ready in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{info.get('seconds', 0.0):.2f} s, built {info.get('built')})")
    for stem, log in info.get("log", {}).items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    # ---------------------------------------------------------------- data
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    path = synthetic.make_dataset_dir(root, num_users=USERS, num_items=ITEMS,
                                      num_ratings=RATINGS, seed=SEED)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    model_cls, _ = reg.get_model("BPRMF")
    model = model_cls(RunConfig(recommender="BPRMF", data_dir=path,
                                seed=SEED),
                      {"n_dim": DIM, "epochs": EPOCHS, "early_stop": EPOCHS})
    require((model.num_users, model.num_items, model.dataset.num_ratings)
            == (USERS, ITEMS, RATINGS), "catalog size")
    require(model.user_emb.device == dev
            and model.item_emb.shape == (ITEMS, DIM), "model on the card")
    server = TopKRecommender(model, k=K)
    seen_w = server._seen.shape[1]
    ev = model.evaluator
    test_users = np.fromiter(ev.user_pos_test, np.int64)
    print(f"data + model ready in {time.perf_counter() - t0:.1f} s: "
          f"{USERS} users, {ITEMS} items, {RATINGS} interactions, "
          f"seen-table width {seen_w}, {len(test_users)} test users",
          flush=True)

    # ------------------------------------------- phase 2: kernels vs plain
    mark("2")
    rng = np.random.default_rng(SEED + 1)
    errs: dict = {}
    users = torch.as_tensor(rng.integers(0, USERS, B_KERNEL), device=dev)
    scores = model.predict(users)
    mask = server._seen[users]
    bmf, tau, cv, ci = check_chain("slice shape", scores, mask, K, errs)
    adversarial(dev, errs)
    eval_in = {}
    for bsz in (B_EVAL, B_KERNEL):
        u = rng.choice(test_users, bsz, replace=False)
        tr, te, tl = ev._tables_for(u, ITEMS)
        eval_in[bsz] = (u, model.predict(u), torch.from_numpy(tr).to(dev),
                        torch.from_numpy(te).to(dev),
                        torch.from_numpy(np.maximum(tl, 1)).to(dev))
        check_ranks(f"evaluation shape B={bsz}", *eval_in[bsz][1:4], K_EVAL,
                    errs)
    t_eval, l_eval = eval_in[B_EVAL][3].shape[1], eval_in[B_EVAL][2].shape[1]
    adversarial_ranks(dev, errs)
    check_ordered_sums(
        dev, model.dataset.train_data.to_user_item_pairs()[:, 1], errs)
    print(f"kernels == plain versions (max abs err {errs}); evaluation "
          f"tables: train width {l_eval}, test width T={t_eval}", flush=True)

    # ---------------------------------------------------- phase 3: serving
    mark("3")
    served = []

    def serve_all():
        for bs in BATCHES:
            u = rng.integers(0, USERS, bs)
            served.append((u,) + server.recommend(u))
    _, serve_launches = counted(serve_all)
    print(f"launches while serving {len(BATCHES)} requests: "
          f"{serve_launches}")
    for kname in SERVING:
        require(serve_launches[kname] >= 1,
                f"{kname} never launched while serving")
    seen = model.dataset.train_data.to_user_dict()
    for u, ids, vals in served:
        s_cpu = check_served(server, u, ids, vals, seen)
        # predict against float64 on the CPU: |err| <= 1e-6 + 1e-5 |ref|
        u_t = torch.as_tensor(u, device=dev)
        ue = model.user_emb.detach()[u_t].cpu().double()
        ref = ue @ model.item_emb.detach().cpu().double().T \
            + model.item_bias.detach().cpu().double()
        np.testing.assert_allclose(s_cpu.double().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
    print("recommend == plain top-k of the same scores, no seen item, "
          "predict within 1e-6 + 1e-5|ref| of float64", flush=True)
    host = _host_call_times().measure(server, rng)
    print(f"host time a call: {host}  [{card}]", flush=True)
    export_launches, finish_fresh_load = check_export(
        server, rng, seen, os.path.join(root, "export"), card)

    # ---------------------------------------- phase 4: training at Gowalla
    mark("4")
    ndcg0 = model.evaluate()["NDCG@10"]
    fit_routes = traced_routes(model)
    best, fit_launches = counted(model.fit)
    losses = [h["loss"] for h in model.history]
    print(f"launches during fit() ({EPOCHS} epochs + {EPOCHS} evaluations):"
          f" {fit_launches}")
    require(len(losses) == EPOCHS and bool(np.isfinite(losses).all())
            and losses[1] < losses[0], f"losses finite and falling: {losses}")
    for kname in ("submax", "kth_largest", "extract", "rank_count"):
        require(fit_launches[kname] >= 1, f"{kname} never launched in fit()")
    require(best["NDCG@10"] > ndcg0,
            f"NDCG@10 {best['NDCG@10']} not above the untrained {ndcg0}")
    metric_err = metrics_card_vs_plain(
        model, rng.choice(test_users, B_KERNEL, replace=False))
    print(f"fit(): losses {losses}, NDCG@10 {ndcg0} untrained -> "
          f"{best['NDCG@10']} (Recall@10 {best['Recall@10']}); per-user "
          f"metrics of {B_KERNEL} users card vs plain route: max abs err "
          f"{metric_err}", flush=True)
    check_routes("BPRMF Gowalla", model, fit_routes, card)
    epoch_routes(model, "BPRMF Gowalla", card)

    # ------------------------------------------ phase 5: ML-1M-scale catalog
    mark("5")
    ml_root = os.path.join(root, "ml1m")
    t0 = time.perf_counter()
    ml_path = synthetic.make_dataset_dir(ml_root, num_users=ML_USERS,
                                         num_items=ML_ITEMS,
                                         num_ratings=ML_RATINGS, seed=SEED)
    ml = model_cls(RunConfig(recommender="BPRMF", data_dir=ml_path,
                             seed=SEED), {"epochs": 1, "early_stop": 1})
    require((ml.num_users, ml.num_items, ml.dataset.num_ratings)
            == (ML_USERS, ML_ITEMS, ML_RATINGS), "ML-1M catalog size")
    ml_ev = ml.evaluator
    ml_test = np.fromiter(ml_ev.user_pos_test, np.int64)
    print(f"ML-1M-scale data + model ready in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    ml_best, ml_launches = counted(ml.fit)
    print(f"launches during ML-1M-scale fit() (1 epoch + evaluate()): "
          f"{ml_launches}")
    require(ml_launches["direct_rank"] >= 1
            and ml_launches["rank_count"] == 0,
            "the small catalog must take the direct_rank route")
    require(bool(np.isfinite(ml.history[0]["loss"])), "ML-1M loss finite")
    u = rng.choice(ml_test, B_EVAL, replace=False)
    tr, te, _ = ml_ev._tables_for(u, ML_ITEMS)
    ml_in = (ml.predict(u), torch.from_numpy(tr).to(dev),
             torch.from_numpy(te).to(dev))
    check_ranks(f"ML-1M evaluation shape B={B_EVAL}", *ml_in, K_EVAL, errs)
    print(f"ML-1M-scale: loss {ml.history[0]['loss']}, NDCG@10 "
          f"{ml_best['NDCG@10']}; direct_rank == plain at B={B_EVAL}, "
          f"T={te.shape[1]}, L={tr.shape[1]}", flush=True)

    # ----------------------------------------- phase 6: LightGCN at Gowalla
    mark("6")
    t0 = time.perf_counter()
    reg.load_skrx_model("LightGCN")
    gcn_cls, _ = reg.get_model("LightGCN")
    gcn = gcn_cls(RunConfig(recommender="LightGCN", data_dir=path,
                            seed=SEED),
                  {"epochs": EPOCHS, "early_stop": EPOCHS})
    graph, gcfg = gcn.graph, gcn.config
    layers, gsteps = gcfg.n_layers, gcn.pipeline.num_batches
    fseg = graph.fwd
    require(graph.num_nodes == USERS + ITEMS and gcfg.embed_size == DIM
            and gcn.user_emb.device == dev and fseg.src.device == dev,
            "LightGCN at full width on the card")
    print(f"LightGCN ready in {time.perf_counter() - t0:.1f} s: "
          f"{graph.num_nodes} rows, {graph.num_edges} edges, largest "
          f"in-degree {fseg.max_degree} (mean "
          f"{graph.num_edges / graph.num_nodes}); {fseg.seg_dst.shape[0]} "
          f"segments of <= {ss.SEGMENT_EDGES} edges, "
          f"{fseg.merge_row.shape[0]} rows merged from {fseg.num_partials} "
          f"partials; {gsteps} steps an epoch", flush=True)
    # 1. the kernel against its float64 plain version, real graph and
    # adversarial ones
    ego = torch.cat([gcn.user_emb, gcn.item_emb]).detach()
    keep = torch.rand(graph.num_edges, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED)) < 0.8
    drop_mask = keep.float() / 0.8
    shares = [check_segsum(getattr(graph, direction), ego, m, msg, errs)
              for msg in MSG for direction in ("fwd", "bwd")
              for m in (None, drop_mask)]
    print(f"segsum at the Gowalla graph (D={DIM}, A and A^T, f32 and bf16 "
          f"messages, with and without a 0.8 dropout mask): worst error "
          f"{max(a for a, _ in shares)} of the bound 1e-5 sum|msg|, the f32 "
          f"plain version's {max(b for _, b in shares)}", flush=True)
    require(fseg.num_partials > 0, "the Gowalla graph has rows to merge")
    for msg in MSG:
        check_repeat(fseg, ego, drop_mask, msg)
    segsum_adversarial(dev, errs)
    # 2. the gradient of one batch's loss, card against plain on the CPU
    batch = next(gcn.pipeline.batches(epoch_generator(SEED, 0, dev)))
    params = [gcn.user_emb, gcn.item_emb]
    hyper = (layers, gcfg.reg, gcfg.batch_size)
    loss = lightgcn_loss(graph, *params, *hyper, *batch)
    grads = torch.autograd.grad(loss, params)
    cpu_params = [p.detach().cpu().requires_grad_(True) for p in params]
    loss_cpu = lightgcn_loss(graph.to("cpu"), *cpu_params, *hyper,
                             *(t.cpu() for t in batch))
    grads_cpu = torch.autograd.grad(loss_cpu, cpu_params)
    for name_, g_card, g_cpu in zip(("user_emb", "item_emb"), grads,
                                    grads_cpu):
        scale = float(g_cpu.abs().max())
        gerr = float((g_card.cpu() - g_cpu).abs().max())
        require(gerr <= 1e-5 * scale + 1e-30,
                f"{name_} gradient off by {gerr} (scale {scale})")
        print(f"gradient of one batch's loss, {name_}: max |card - plain| "
              f"{gerr}, max |grad| {scale}; loss card {float(loss.detach())}, "
              f"plain {float(loss_cpu.detach())}", flush=True)
    del grads, grads_cpu, loss, loss_cpu
    # 3. fit(): the segsum launches are counted exactly
    gcn_ndcg0 = gcn.evaluate()["NDCG@10"]
    gcn_routes = traced_routes(gcn)
    gcn_best, gcn_launches = counted(gcn.fit)
    gcn_losses = [h["loss"] for h in gcn.history]
    evals = sum("report" in h for h in gcn.history)
    warm = check_routes("LightGCN Gowalla", gcn, gcn_routes, card)
    # the replays count what their capture recorded; the warm-up steps
    # before the capture launch as any step
    expect = (EPOCHS * gsteps * 2 * layers + layers * evals
              + warm * 2 * layers)
    print(f"launches during LightGCN fit() ({EPOCHS} epochs + {evals} "
          f"evaluations, {warm} warm-up steps): {gcn_launches}; expected "
          f"segsum {expect}", flush=True)
    require(gcn_launches["segsum"] == expect,
            f"segsum: {gcn_launches['segsum']} launches, not {expect}")
    for kname in ("submax", "kth_largest", "extract", "rank_count"):
        require(gcn_launches[kname] >= 1,
                f"{kname} never launched in LightGCN fit()")
    require(len(gcn_losses) == EPOCHS and bool(np.isfinite(gcn_losses).all())
            and gcn_losses[1] < gcn_losses[0],
            f"LightGCN losses finite and falling: {gcn_losses}")
    require(gcn_best["NDCG@10"] > gcn_ndcg0, f"LightGCN NDCG@10 "
            f"{gcn_best['NDCG@10']} not above the untrained {gcn_ndcg0}")
    print(f"LightGCN fit(): losses {gcn_losses}, NDCG@10 {gcn_ndcg0} "
          f"untrained -> {gcn_best['NDCG@10']} (Recall@10 "
          f"{gcn_best['Recall@10']})", flush=True)
    # 4. serving from the frozen propagated embeddings
    gcn_server = TopKRecommender(gcn, k=K)
    gcn_served, gcn_serve_launches = counted(lambda: [
        (u,) + gcn_server.recommend(u)
        for u in (rng.integers(0, USERS, bs) for bs in GCN_SERVE)])
    print(f"launches while serving LightGCN {GCN_SERVE}: "
          f"{gcn_serve_launches}")
    require(gcn_serve_launches["segsum"] == 0,
            "serving reuses the embeddings frozen by the last evaluate()")
    for kname in SERVING:
        require(gcn_serve_launches[kname] >= 1,
                f"{kname} never launched while serving LightGCN")
    for u, ids, vals in gcn_served:
        check_served(gcn_server, u, ids, vals, seen)
    print("LightGCN recommend == plain top-k of the same scores, no seen "
          "item", flush=True)
    epoch_routes(gcn, "LightGCN Gowalla", card, "segsum")

    # ------------------------- phase 7: fused score-and-select and chunked
    finish_fresh_load()                    # started in phase 3
    mark("7")
    # 1. the kernels against their plain versions
    packed_s = dt.pack_items(model.item_emb, model.item_bias)
    uv_s = model.user_emb.detach()[users]
    tau_s, fcv, fci = check_fused("serving shape", uv_s, packed_s, mask, K,
                                  errs)
    for bsz in (1, 7):              # the smallest tiles and clusters
        check_fused(f"serving shape B={bsz}", uv_s[:bsz], packed_s,
                    mask[:bsz], K, errs)
    fused_eval_in = {}
    for bsz in (B_EVAL, B_KERNEL):
        u, _, tr, te, _ = eval_in[bsz]
        u_t = torch.as_tensor(u, device=dev)
        fused_eval_in[bsz] = check_fused(
            f"evaluation shape B={bsz}", model.user_emb.detach()[u_t],
            packed_s, tr, K_EVAL, errs)
        check_lookup(f"evaluation shape B={bsz}", *fused_eval_in[bsz][1:], te,
                     errs)
    fused_adversarial(dev, model.item_emb.detach(), errs)
    print(f"fused kernels == plain versions (max abs err "
          f"{ {k: errs.get(k, 0.0) for k in FUSED + ('rank_lookup_count',)} }"
          f"); evaluation tables T={t_eval}, L={l_eval}", flush=True)
    # 2. fused serving
    fused_launches = {}
    for tag, m in (("BPRMF", model), ("LightGCN", gcn)):
        fsrv = TopKRecommender(m, k=K, fused="always")
        require(fsrv.fused, f"{tag}: a dot model takes the fused route")
        answers, launched = counted(lambda: [
            serve_measured(fsrv, rng.integers(0, USERS, bs))
            for bs in GCN_SERVE])
        fused_launches[tag] = launched
        differ = [check_fused_served(fsrv, *a, seen) for a in answers]
        print(f"fused serving {tag} {GCN_SERVE}: launches {launched}; rows "
              f"unlike the score-matrix route {differ}", flush=True)
        for kname in FUSED + ("kth_largest", "pruned_merge"):
            require(launched[kname] >= 1,
                    f"{kname} never launched in fused serving of {tag}")
        require(launched["submax"] == launched["extract"] == 0,
                "fused serving built a score matrix")
    # 3. fused and chunked evaluate()
    eval_runs = {}
    for tag, m, modes in (("BPRMF", model, ("full", "fused", "chunked")),
                          ("LightGCN", gcn, ("full", "fused"))):
        for mode in modes:
            (rep, sec), launched = counted(lambda: evaluate_as(m, mode, CHUNK))
            eval_runs[tag, mode] = (rep, sec, launched)
        full = np.array(list(eval_runs[tag, "full"][0].values()))
        for mode in modes[1:]:
            rep, sec, launched = eval_runs[tag, mode]
            diff = float(np.abs(np.array(list(rep.values())) - full).max())
            print(f"{tag} evaluate() eval_mode={mode!r}: {sec} s, NDCG@10 "
                  f"{rep['NDCG@10']} (full {eval_runs[tag, 'full'][0]['NDCG@10']}"
                  f"), largest metric difference to the full route {diff}; "
                  f"launches {launched}", flush=True)
            require(diff <= 1e-4, f"{tag} {mode}: metrics off by {diff}")
            need = (FUSED + ("kth_largest", "rank_lookup_count")
                    if mode == "fused" else ("vmem_topk",))
            for kname in need:
                require(launched[kname] >= 1,
                        f"{kname} never launched in {mode} evaluate() of {tag}")
            require(launched["rank_count"] == 0,
                    f"{mode} evaluate() took the full route")
    # 4. a catalog that only the fused route serves cheaply
    gen = torch.Generator(dev).manual_seed(SEED)
    big_items = torch.randn((BIG_ITEMS, DIM), device=dev, generator=gen)
    big_bias = torch.randn((BIG_ITEMS,), device=dev, generator=gen)
    big_uv = torch.randn((BIG_B, DIM), device=dev, generator=gen)
    big_seen = torch.randint(0, BIG_ITEMS, (BIG_B, 300), device=dev,
                             generator=gen, dtype=torch.int32)
    big_seen[:, -20:] = BIG_ITEMS                       # padding
    big_packed, pack_peak = peak_above(
        lambda: dt.pack_items(big_items, big_bias))
    (bv, bi), big_fused_peak = peak_above(lambda: dt.dot_topk(
        big_uv, None, None, K, mask_table=big_seen, packed=big_packed))
    rv, ri = dt.dot_topk_plain(big_uv, big_packed, K, big_seen)
    expect_equal(f"dot_topk N={BIG_ITEMS}", [bv, bi], [rv.cpu(), ri.cpu()],
                 errs, "dot_extract")
    del rv, ri
    _, big_matrix_peak = peak_above(lambda: tb.blockwise_topk(
        torch.matmul(big_uv, big_items.T) + big_bias, K,
        mask_table=big_seen))
    print(f"catalog of {BIG_ITEMS} items, B={BIG_B}, d={DIM}: dot_topk == "
          f"plain; peak device memory above the allocated: fused "
          f"{big_fused_peak} B (packing the table once {pack_peak} B), "
          f"score-matrix route {big_matrix_peak} B", flush=True)
    require(big_fused_peak < 4 * BIG_B * BIG_ITEMS,
            "the fused route must allocate less than one score matrix")

    # ----------------------- phase 8: the rest of fit(); Pop, AOBPR and CML
    mark("8")
    p8 = phase_fit_and_models(root, path, reg, model_cls, dev, rng,
                              test_users)
    lazy, pop, ao, cml = p8["lazy"], p8["pop"], p8["ao"], p8["cml"]

    # ------------------------ phase 10: LayerGCN, LightGCL and DENS (#11)
    mark("10")
    p10 = phase_graph_models(path, reg, dev)
    lg, gcl, dn = p10["LayerGCN"], p10["LightGCL"], p10["DENS"]

    # --------------- phase 11: SelfCF, CDAE and MultVAE (#11, the towers)
    mark("11")
    p11 = phase_selfcf_and_autoencoders(path, reg, dev, card, errs)
    sc, cd, mv = p11["SelfCF"], p11["CDAE"], p11["MultVAE"]

    # ------- phase 12: FPMC, TransRec, SGAT (#11, traced weights), Caser, HGN
    mark("12")
    p12 = phase_sequential_models(path, reg, dev, card, errs)
    sequential = [(f"{tag} Gowalla", p12[tag]) for tag in
                  ("FPMC", "TransRec", "SGAT", "Caser", "HGN")]

    # ---- phase 13: GRU4Rec, GRU4RecPlus, SASRec, BERT4Rec, SRGNN (towers)
    mark("13")
    p13 = phase_sequence_towers(path, reg, dev, card, errs) \
        if 13 not in skip else {"runs": []}

    # ------ phase 14: the multimodal models (#11; kNN graphs through #1-#4)
    mark("14")
    p14 = phase_multimodal(path, reg, dev, card, errs) \
        if 14 not in skip else {"runs": []}

    # -------------------- phase 15: the command line (#11, #1-#3, #6)
    mark("15")
    p15 = phase_command_line(path, os.path.join(root, "cli")) \
        if 15 not in skip else {"runs": []}

    # ---- phase 16: the mesh, ranks sharing the card (#11, #1-#5 a rank)
    mark("16")
    p16 = phase_mesh(path, os.path.join(root, "mesh"), card) \
        if 16 not in skip else {"runs": []}
    # ------- phase 17: every other model on (2, 2) (#11, #1-#5 a rank)
    mark("17")
    p17 = phase_mesh_models(path, os.path.join(root, "mesh_models"), card) \
        if 17 not in skip else {"runs": []}
    # ------ phase 18: the long-run sweep, cut (#11, the rank kernels)
    mark("18")
    p18 = phase_longrun(os.path.join(root, "longrun"), card) \
        if 18 not in skip else {"runs": []}

    # ------------------------------------------------------ phase 9: times
    mark("9")
    b, n, w_sub, w_c = B_KERNEL, ITEMS, bmf.shape[1], cv.shape[1]
    s_masked = tb._masked_padded(scores, mask, BLOCK_N).reshape(b, -1, BLOCK_N)
    found = ((s_masked >= tau[:, None, None]) & (s_masked != NEG_INF)).sum(2)
    del s_masked
    # rank_count at the evaluation batch of the Gowalla route;
    # rank_lookup_count on the fused candidates of the same batch
    e_u, e_sc, e_tr, e_te, e_tl = eval_in[B_EVAL]
    _, l_cv, l_ci = fused_eval_in[B_EVAL]
    w_l = l_cv.shape[1]
    e_cv, e_ci, _ = tb.blockwise_candidates(e_sc, K_EVAL, BLOCK_N, e_tr)
    e_st = e_sc.gather(1, e_te.clamp(0, ITEMS - 1).long())
    be, w_r = e_sc.shape[0], e_cv.shape[1]
    # direct_rank at the evaluation batch of the ML-1M route; its work
    # counts the probes that are found (in range, unmasked, finite)
    m_sc, m_tr, m_te = ml_in
    m_safe = m_te.clamp(0, ML_ITEMS - 1)
    m_valid = int(((m_te >= 0) & (m_te < ML_ITEMS)
                   & ~tb._in_rows(m_tr, m_safe)
                   & torch.isfinite(m_sc.gather(1, m_safe.long()))).sum())
    bm_, tm_, lm_ = m_sc.shape[0], m_te.shape[1], m_tr.shape[1]
    # segsum at the Gowalla graph, forward (A) on the ego embeddings as in
    # the first layer of a training step
    n_rows, n_edges, n_seg = graph.num_nodes, graph.num_edges, \
        fseg.seg_dst.shape[0]
    n_part, n_merge = fseg.num_partials, fseg.merge_row.shape[0]
    # the CSR matrix of A (the segments' edges in row order)
    by_row = torch.argsort(fseg.dst, stable=True)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(fseg.dst.long(),
                                           minlength=n_rows), 0)
    a_csr = torch.sparse_csr_tensor(crow, fseg.src[by_row].long(),
                                    fseg.weight[by_row], (n_rows, n_rows))
    require(bool(torch.allclose(torch.sparse.mm(a_csr, ego),
                                ss.segsum(fseg, ego), rtol=1e-4, atol=1e-6)),
            "torch.sparse.mm of the CSR matrix computes the same function")
    # vmem_topk (#5) at its own shape, chunked evaluate()'s merge: the
    # running best (B=64, k=50) beside one chunk's top 50
    tops = [torch.topk(e_sc[:, lo:lo + CHUNK], K_EVAL, dim=1)
            for lo in (0, CHUNK)]
    c_v = torch.cat([t.values for t in tops], 1).contiguous()
    c_i = torch.cat([tops[0].indices, tops[1].indices + CHUNK],
                    1).to(torch.int32).contiguous()
    neg_e = torch.full((be,), NEG_INF, device=dev)
    w_m = c_v.shape[1]
    expect_equal("vmem_topk at the chunk-merge shape",
                 tb.vmem_topk(c_v, c_i, K_EVAL),
                 tb.pruned_merge_plain(c_v.cpu(), c_i.cpu(), K_EVAL,
                                       neg_e.cpu()), errs, "vmem_topk")
    work = {   # (bytes moved, operations) for this run's inputs
        "submax": (4 * (b * n + b * seen_w + b * w_sub), b * n),
        "kth_largest": (4 * (b * w_sub + b), 2 * 33 * b * w_sub),
        "extract": (4 * (b * n + b * seen_w + b) + 8 * b * w_c,
                    b * n + select_ops(found, K)),
        "pruned_merge": (8 * b * w_c + 4 * b + 8 * b * K, 2 * K * b * w_c),
        "vmem_topk": (8 * be * w_m + 4 * be + 8 * be * K_EVAL,
                      2 * K_EVAL * be * w_m),
        # a compare and an add per (probe, segment of equal keys) pair
        "rank_count": (8 * be * w_r + 12 * be * t_eval,
                       2 * t_eval * int(rank_segments(e_cv, e_ci).sum())),
        # a compare and an add per (found probe, column) pair
        "direct_rank": (4 * (bm_ * ML_ITEMS + bm_ * lm_ + 2 * bm_ * tm_),
                        2 * m_valid * ML_ITEMS),
        # x once, each edge's source id and weight, the segment and merge
        # tables, the counters read and reset, the output written (partial
        # rows are the kernel's scratch); a multiply and an add per (edge,
        # feature), an add per partial feature
        "segsum": (4 * (2 * n_rows * DIM + 2 * n_edges + 2 * n_seg + 1
                        + n_part + 4 * n_merge + 1),
                   2 * n_edges * DIM + n_part * DIM),
        # uv, the item table and bias once, the seen table, the maxima
        # written; a multiply and an add per (row, item, dimension)
        "dot_submax": (4 * (b * DIM + n * DIM + n + b * seen_w + b * w_sub),
                       2 * b * n * DIM),
        "dot_extract": (4 * (b * DIM + n * DIM + n + b * seen_w + b)
                        + 8 * b * w_c, 2 * b * n * DIM),
        # the candidates and probes once, ranks and found written; a
        # compare and an add per (probe, segment of equal keys) pair (the
        # count), a compare per (probe, candidate whose value is not -inf)
        # pair (the lookup: only those can give a score above -inf)
        "rank_lookup_count": (8 * be * w_l + 4 * be * t_eval + 5 * be * t_eval,
                              t_eval * (2 * int(rank_segments(l_cv, l_ci).sum())
                                        + int((l_cv != NEG_INF).sum()))),
    }
    # the whole propagate as a user calls it: x, the CSR arrays (row
    # offsets, source ids, weights) and the output
    prop_bytes = 4 * (2 * n_rows * DIM + n_rows + 1 + 2 * n_edges)
    neg = torch.full_like(tau, NEG_INF)
    kernel_fns = {
        "submax": (lambda: tb.submax(scores, mask, BLOCK_N),
                   lambda: tb.submax_plain(scores, mask, BLOCK_N), None),
        "kth_largest": (lambda: tb.kth_largest(bmf, K),
                        lambda: tb.kth_largest_plain(bmf, K),
                        lambda: torch.kthvalue(bmf, w_sub - K + 1, dim=1)),
        "extract": (lambda: tb.extract(scores, tau, K, mask, BLOCK_N),
                    lambda: tb.extract_plain(scores, mask, tau, K, BLOCK_N),
                    None),
        "pruned_merge": (lambda: tb.pruned_merge(cv, ci, K, tau),
                         lambda: tb.pruned_merge_plain(cv, ci, K, tau),
                         lambda: torch.topk(cv, K, dim=1)),
        "vmem_topk": (lambda: tb.vmem_topk(c_v, c_i, K_EVAL),
                      lambda: tb.pruned_merge_plain(c_v, c_i, K_EVAL, neg_e),
                      lambda: torch.topk(c_v, K_EVAL, dim=1)),
        "rank_count": (lambda: tb.rank_count(e_cv, e_ci, e_st, e_te),
                       lambda: tb.rank_count_plain(e_cv, e_ci, e_st, e_te),
                       None),
        "direct_rank": (lambda: tb.direct_rank(m_sc, m_te, K_EVAL, m_tr),
                        lambda: tb.direct_rank_plain(m_sc, m_tr, m_te,
                                                     K_EVAL), None),
        "segsum": (lambda: ss.segsum(fseg, ego),
                   lambda: ss.segsum_plain(fseg, ego),
                   lambda: torch.sparse.mm(a_csr, ego)),
        # no single PyTorch call computes these; the fused top-k as a
        # whole is held against matmul + mask_items + torch.topk below
        "dot_submax": (lambda: dt.dot_submax(uv_s, packed_s, mask),
                       lambda: dt.dot_submax_plain(uv_s, packed_s, mask),
                       None),
        "dot_extract": (
            lambda: dt.dot_extract(uv_s, packed_s, tau_s, K, mask),
            lambda: dt.dot_extract_plain(uv_s, packed_s, mask, tau_s, K),
            None),
        "rank_lookup_count": (
            lambda: tb.rank_lookup_count(l_cv, l_ci, e_te),
            lambda: tb.rank_lookup_count_plain(l_cv, l_ci, e_te), None),
    }
    # launches over every main-path run of this script: serving, the
    # loaded exported tail, both fit()s at Gowalla, the ML-1M-scale fit(),
    # LightGCN serving, fused serving, the fused and chunked evaluate()
    # calls, phase 8's fit()s and evaluations (lazy Adam, resume, profile,
    # groups, Pop, AOBPR, CML), phase 10's (LayerGCN, LightGCL, DENS),
    # phase 11's (SelfCF, CDAE, MultVAE), phase 12's (FPMC, TransRec, SGAT, Caser, HGN), phase 13's
    # (the sequence towers), phase 14's (the kNN builds and the
    # multimodal models), phase 15's (the command line's runs), phase
    # 16's and 17's (the single-device and every rank's fit() on the mesh)
    # and phase 18's (the long-run sweep's fit()s)
    path_runs = [serve_launches, export_launches, fit_launches, ml_launches,
                 gcn_launches, gcn_serve_launches, *fused_launches.values(),
                 *(r[2] for r in eval_runs.values()), *p8["runs"],
                 *p10["runs"], *p11["runs"], *p12["runs"], *p13["runs"],
                 *p14["runs"], *p15["runs"], *p16["runs"],
                 *p17["runs"], *p18["runs"]]
    launches = {k: sum(r[k] for r in path_runs) for k in runtime.KERNELS}
    shapes = {k: f"B={b}, N={n}, k={K}, L={seen_w}" for k in SERVING}
    shapes["vmem_topk"] = (f"B={be}, W={w_m}, k={K_EVAL}: chunked "
                           f"evaluate()'s merge")
    for kname in FUSED:
        shapes[kname] = f"B={b}, N={n}, d={DIM}, k={K}, L={seen_w}"
    shapes["rank_lookup_count"] = (
        f"B={be}, N={ITEMS}, k={K_EVAL}, W={w_l}, T={t_eval}; a row "
        f"{float(rank_segments(l_cv, l_ci).double().mean())} segments, "
        f"{float((l_cv != NEG_INF).sum(1).double().mean())} lanes not -inf")
    shapes["rank_count"] = (f"B={be}, N={ITEMS}, k={K_EVAL}, W={w_r}, "
                            f"T={t_eval}")
    shapes["direct_rank"] = (f"B={bm_}, N={ML_ITEMS}, k={K_EVAL}, L={lm_}, "
                             f"T={tm_}, found {m_valid}")
    shapes["segsum"] = (f"N={n_rows}, E={n_edges}, D={DIM}, {n_seg} "
                        f"segments, {n_merge} rows merged from {n_part} "
                        f"partial rows")
    rows = []
    for kname in runtime.KERNELS:
        fn, plain, lib = kernel_fns[kname]
        nbytes, ops = work[kname]
        t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_OPS * 1e3
        row = {"name": kname, "route": "cuda", "source": SOURCE[kname],
               "replaces": REPLACES[kname], "launches": launches[kname],
               "max_abs_err": errs.get(kname, 0.0),
               "ms": device_ms(fn),
               "plain_ms": device_ms(plain),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None if lib is None else device_ms(lib)}
        rows.append(row)
        print(f"{kname:13s} {row['ms']} ms  bound {row['bound_ms']} ms "
              f"({row['bound_by']})  plain {row['plain_ms']} ms  library "
              f"{row['library_ms']}  (device time per call); one wrapper "
              f"call between CUDA events {time_ms(fn)} ms, plain "
              f"{time_ms(plain)} ms; 200 back-to-back calls between CUDA "
              f"events {launches_ms(fn)} ms a call; launches on its path "
              f"{launches[kname]}  [{card}, {shapes[kname]}]", flush=True)
    prop_bound = max(prop_bytes / MEM_RATE, 2 * n_edges * DIM / F32_OPS) * 1e3
    print(f"propagate at the Gowalla graph (segsum, one launch with its "
          f"merge pass, as a user calls it): f32 messages {device_ms(lambda: ss.segsum(fseg, ego))}"
          f" ms, bf16 messages "
          f"{device_ms(lambda: ss.segsum(fseg, ego, None, torch.bfloat16))} "
          f"ms, with a dropout mask "
          f"{device_ms(lambda: ss.segsum(fseg, ego, drop_mask))} ms of device "
          f"time; one call between CUDA events "
          f"{time_ms(lambda: ss.segsum(fseg, ego))} ms; bound "
          f"{prop_bound} ms (bytes, {prop_bytes} B: x, CSR, output) "
          f"[{card}, {shapes['segsum']}]", flush=True)
    n_full = ITEMS // BLOCK_N * BLOCK_N
    two_calls = device_ms(lambda: torch.amax(metrics.mask_items(
        scores, mask)[:, :n_full].reshape(b, -1, BLOCK_N // 128, 128), dim=2))
    vmem_ms = (device_ms(lambda: tb.pruned_merge(cv, ci, K, neg)),
               time_ms(lambda: tb.pruned_merge(cv, ci, K, neg)))
    total = time_ms(lambda: tb.blockwise_topk(scores, K, mask_table=mask))

    def masked_topk():
        return torch.topk(metrics.mask_items(scores, mask), K, dim=1)
    print(f"submax yardstick, two calls (mask_items + amax over the "
          f"{n_full // BLOCK_N} full column blocks): {two_calls} ms of "
          f"device time; "
          f"vmem_topk (tau=-inf) {vmem_ms[0]} ms of device time, "
          f"{vmem_ms[1]} ms between CUDA events; blockwise_topk total "
          f"{total} ms vs masked torch.topk {time_ms(masked_topk)} ms; "
          f"predict {time_ms(lambda: model.predict(users))} ms "
          f"[{card}, B={b}]")
    # vmem_topk (#5) at its own shape: its row above
    t_bytes = (8 * be * w_m + 4 * be + 8 * be * K_EVAL) / MEM_RATE * 1e3
    t_ops = 2 * K_EVAL * be * w_m / F32_OPS * 1e3
    print(f"vmem_topk (pruned_merge, tau=-inf) at the chunked-evaluation "
          f"merge (B={be}, W={w_m}, k={K_EVAL}): "
          f"{device_ms(lambda: tb.vmem_topk(c_v, c_i, K_EVAL))} ms of device "
          f"time, bound {max(t_bytes, t_ops)} ms ("
          f"{'bytes' if t_bytes >= t_ops else 'operations'}), plain "
          f"{device_ms(lambda: tb.pruned_merge_plain(c_v, c_i, K_EVAL, neg_e))}"
          f" ms, library torch.topk "
          f"{device_ms(lambda: torch.topk(c_v, K_EVAL, dim=1))} ms  [{card}]",
          flush=True)
    # the fused top-k as a whole, beside the score-matrix route and the
    # library yardstick; the fused kernels at the evaluation batch
    def matrix_topk(uv, items, bias, seen_rows):
        return tb.blockwise_topk(torch.matmul(uv, items.T) + bias, K,
                                 mask_table=seen_rows)
    item_w, item_b = model.item_emb.detach(), model.item_bias.detach()
    for tag, fused_fn, matrix_fn, lib_fn in (
            (f"B={b}, N={n}",
             lambda: dt.dot_topk(uv_s, None, None, K, mask, packed=packed_s),
             lambda: matrix_topk(uv_s, item_w, item_b, mask),
             lambda: torch.topk(metrics.mask_items(
                 torch.matmul(uv_s, item_w.T) + item_b, mask), K, dim=1)),
            (f"B={BIG_B}, N={BIG_ITEMS}",
             lambda: dt.dot_topk(big_uv, None, None, K, big_seen,
                                 packed=big_packed),
             lambda: matrix_topk(big_uv, big_items, big_bias, big_seen),
             lambda: torch.topk(metrics.mask_items(
                 torch.matmul(big_uv, big_items.T) + big_bias, big_seen), K,
                 dim=1))):
        print(f"top-{K} {tag}, d={DIM}: fused dot_topk {device_ms(fused_fn)} "
              f"ms of device time ({time_ms(fused_fn)} ms between CUDA "
              f"events); score-matrix route (matmul + blockwise_topk) "
              f"{device_ms(matrix_fn)} ms ({time_ms(matrix_fn)}); library "
              f"yardstick matmul + mask_items + torch.topk "
              f"{device_ms(lib_fn)} ms ({time_ms(lib_fn)})  [{card}]",
              flush=True)
    # the selection kernels at the evaluation batch (B=64, k=50), where 934
    # of the fused kernels' launches and nearly all of kth_largest's are
    e_uv = model.user_emb.detach()[torch.as_tensor(e_u, device=dev)]
    e_tau_f = fused_eval_in[B_EVAL][0]
    e_bm = tb.submax(e_sc, e_tr, BLOCK_N)
    e_bmf = tb.fold_submaxes(e_bm, K_EVAL).contiguous()
    sel_tau = tb.kth_largest(e_bmf, K_EVAL)
    sel_cv, _ = tb.extract(e_sc, sel_tau, K_EVAL, e_tr, BLOCK_N)
    sel_masked = tb._masked_padded(e_sc, e_tr, BLOCK_N).reshape(be, -1, BLOCK_N)
    sel_found = ((sel_masked >= sel_tau[:, None, None])
                 & (sel_masked != NEG_INF)).sum(2)
    del sel_masked
    w_e, w_f, w_ce = e_bm.shape[1], e_bmf.shape[1], sel_cv.shape[1]
    eval_work = {   # (bytes, operations), the kernel, a library call
        "submax": ((4 * (be * n + be * l_eval + be * w_e), be * n),
                   lambda: tb.submax(e_sc, e_tr, BLOCK_N), None),
        "kth_largest": ((4 * (be * w_f + be), 2 * 33 * be * w_f),
                        lambda: tb.kth_largest(e_bmf, K_EVAL),
                        lambda: torch.kthvalue(e_bmf, w_f - K_EVAL + 1,
                                               dim=1)),
        "extract": ((4 * (be * n + be * l_eval + be) + 8 * be * w_ce,
                     be * n + select_ops(sel_found, K_EVAL)),
                    lambda: tb.extract(e_sc, sel_tau, K_EVAL, e_tr, BLOCK_N),
                    None),
        "dot_submax": ((4 * (be * DIM + n * DIM + n + be * l_eval
                             + be * w_e), 2 * be * n * DIM),
                       lambda: dt.dot_submax(e_uv, packed_s, e_tr), None),
        "dot_extract": ((4 * (be * DIM + n * DIM + n + be * l_eval + be)
                         + 8 * be * w_ce, 2 * be * n * DIM),
                        lambda: dt.dot_extract(e_uv, packed_s, e_tau_f,
                                               K_EVAL, e_tr), None),
    }
    for kname, ((nbytes, ops), fn, lib) in eval_work.items():
        t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_OPS * 1e3
        print(f"{kname:13s} at the evaluation shape (B={be}, N={n}, "
              f"k={K_EVAL}, W={w_e} (folded {w_f}), L={l_eval}): "
              f"{device_ms(fn)} ms of device time, bound "
              f"{max(t_bytes, t_ops)} ms ("
              f"{'bytes' if t_bytes >= t_ops else 'operations'}); library "
              f"{None if lib is None else device_ms(lib)} ms; 200 "
              f"back-to-back calls between CUDA events {launches_ms(fn)} ms "
              f"a call  [{card}]", flush=True)
    print(f"direct_rank at the ML-1M evaluation shape ({m_valid} found "
          f"probes of {bm_ * tm_} slots): {device_ms(kernel_fns['direct_rank'][0])} "
          f"ms of device time (torch.profiler, the table's number), "
          f"{launches_ms(kernel_fns['direct_rank'][0], 1000)} ms a call over "
          f"1,000 back-to-back calls between CUDA events (the host's launch "
          f"rate where it is the slower), {time_ms(kernel_fns['direct_rank'][0])} "
          f"ms for one call between CUDA events  [{card}]", flush=True)
    print(f"dot_topk_ranks at the evaluation batch B={be}: "
          f"{time_ms(lambda: dt.dot_topk_ranks(e_uv, None, None, K_EVAL, e_te, e_tr, packed=packed_s))}"
          f" ms between CUDA events  [{card}]", flush=True)
    ranks_ms = time_ms(lambda: tb.masked_topk_ranks(e_sc, K_EVAL, e_te, e_tr))
    metrics_ms = time_ms(lambda: ev.per_user_metrics(e_sc, e_tr, e_te,
                                                     e_tl))
    print(f"evaluation batch B={be}: masked_topk_ranks {ranks_ms} ms, "
          f"per-user metrics (ranks included) {metrics_ms} ms, predict "
          f"{time_ms(lambda: model.predict(e_u))} ms [{card}]")
    fused_server = TopKRecommender(model, k=K, fused="always")
    for bs in BATCHES:
        u = rng.integers(0, USERS, bs)
        for route, srv in (("score matrix", server), ("fused", fused_server)):
            lat = []
            for _ in range(LATENCY_CALLS):
                t0 = time.perf_counter()
                srv.recommend(u)
                lat.append((time.perf_counter() - t0) * 1e3)
            lat = np.sort(lat[5:])
            busy, _ = busy_share(lambda: srv.recommend(u))
            print(f"recommend B={bs:5d} {route:12s}: p50 {lat[len(lat) // 2]}"
                  f" ms  max {lat[-1]} ms  device busy "
                  f"{'not measured' if busy is None else busy}  [{card}]")
    # training and evaluation, end to end
    print(f"[{time.perf_counter() - t_main:.1f} s] training and evaluation "
          f"times", flush=True)
    trained = (("Gowalla", model), ("LightGCN Gowalla", gcn),
               ("lazy-Adam BPRMF Gowalla", lazy), ("AOBPR Gowalla", ao),
               ("CML Gowalla", cml), ("LayerGCN Gowalla", lg),
               ("LightGCL Gowalla", gcl), ("DENS Gowalla", dn),
               ("SelfCF Gowalla", sc), ("CDAE Gowalla", cd),
               ("MultVAE Gowalla", mv), *sequential,
               ("FPMC lazy-Adam Gowalla", p12["FPMC (lazy Adam)"]),
               ("TransRec lazy-Adam Gowalla", p12["TransRec (lazy Adam)"]))
    for tag, m in trained:
        steps = getattr(m, "pipeline", m).num_batches
        for h in m.history:
            print(f"{tag} epoch {h['epoch']}: train {h['train_seconds']} s "
                  f"({steps / h['train_seconds']} steps/s of batch "
                  f"{m.config.batch_size}), evaluate() {h['eval_seconds']} "
                  f"s  [{card}]")
    # dense against lazy Adam (BPRMF), one step at the same batch; the
    # lazy step's duplicate-row sums at its 2,048 item rows
    batch = next(model.pipeline.batches(epoch_generator(SEED + 9, 0, dev)))
    step_ms = {tag: (device_ms(lambda: m.train_step(batch)),
                     time_ms(lambda: m.train_step(batch)))
               for tag, m in (("dense", model), ("lazy", lazy))}
    item_rows = torch.cat([batch[1], batch[2][:, 0]])
    g_rows = torch.randn((item_rows.shape[0], DIM), device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED))
    print(f"BPRMF Gowalla one train step, dense Adam {step_ms['dense'][0]} "
          f"ms of device time ({step_ms['dense'][1]} ms between CUDA "
          f"events), lazy Adam {step_ms['lazy'][0]} ms "
          f"({step_ms['lazy'][1]}); epochs dense "
          f"{[h['train_seconds'] for h in model.history]} s, lazy "
          f"{[h['train_seconds'] for h in lazy.history]} s; dedup_rows of "
          f"{item_rows.shape[0]} rows (d={DIM}) "
          f"{device_ms(lambda: dedup_rows(item_rows, g_rows, ITEMS))} ms of "
          f"device time ({time_ms(lambda: dedup_rows(item_rows, g_rows, ITEMS))}"
          f" between CUDA events)  [{card}]", flush=True)
    for tag, m in (("Gowalla", model), ("ML-1M", ml),
                   ("LightGCN Gowalla", gcn),
                   ("lazy-Adam BPRMF Gowalla", lazy), ("Pop Gowalla", pop),
                   ("AOBPR Gowalla", ao), ("CML Gowalla", cml),
                   ("LayerGCN Gowalla", lg), ("LightGCL Gowalla", gcl),
                   ("DENS Gowalla", dn), ("SelfCF Gowalla", sc),
                   ("CDAE Gowalla", cd), ("MultVAE Gowalla", mv),
                   *sequential):
        n_users = len(m.evaluator.user_pos_test)      # EVAL_USERS's cut
        (_, sec), per_eval = counted(lambda: timed(m.evaluate))
        print(f"{tag} evaluate(): {sec} s, {n_users / sec} users/s, "
              f"launches per evaluate() {per_eval}  [{card}]")
        # the profiler's windows for the main path's models (phases 12-14
        # profile their own models' epochs)
        if m not in (model, ml, gcn, lazy, ao):
            continue
        # the windows over the first EVAL_USERS test users (all: None)
        window = sorted(m.evaluator.user_pos_test)[:EVAL_USERS]
        busy, heads = busy_share(lambda: m.evaluate(window), reps=1,
                                 warm=False, top=6)
        print(f"{tag} evaluate() of {len(window)} users: device busy "
              f"{busy}; top device kernels (ms): {heads}")
        # the models of phases 10-12 had each route timed there
        modes = {model: ("fused", "chunked"), gcn: ("fused",),
                 ao: ("fused",)}.get(m, ())
        for mode in modes:
            (_, sec) = evaluate_as(m, mode, CHUNK, window)
            busy, heads = busy_share(
                lambda: evaluate_as(m, mode, CHUNK, window), reps=1,
                warm=False, top=6)
            print(f"{tag} evaluate() eval_mode={mode!r} of {len(window)} "
                  f"users: {sec} s, {len(window) / sec} users/s; device busy"
                  f" {busy}; top device kernels (ms): {heads}  [{card}]")
        busy, heads = busy_share(lambda: epoch_window(m), reps=1,
                                 warm=False, top=6)
        print(f"{tag} train epoch, its first {TRAIN_WINDOW} steps: "
              f"device busy {busy}; top device kernels (ms): {heads}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30} "
          f"GiB")
    shutil.rmtree(root, ignore_errors=True)
    t_end = time.perf_counter()
    ends = [t for _, t in marks[1:]] + [t_end]
    seconds = {phase: end - t for (phase, t), end in zip(marks, ends)}
    print(f"phase seconds (phase 1 with the kernel build and the data): "
          f"{seconds}; the whole run {t_end - t_main} s  [{card}]",
          flush=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
