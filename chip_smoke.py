#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, the HEALPix-16 bf16 forecast service, the
HEALPix-16 AR6 bf16 training step (and its HEALPix-64 AR2 form, and the
shipped fp32 HEALPix-64 configuration at that traffic), the
same step node- and data-parallel, with BatchNorm and for 2 members at
once, the train -> predict -> verify CLI, serving from artifacts, SWAG
fine-tuning with its ensemble, six shipped configurations over the
other samplings, graph types and pools with the variant architectures,
and the whole mesh (members over ranks, BatchNorm over a data or node
mesh, node-sharded grids), member steps that recompute in the backward,
an experiment built from nothing by the data-preparation CLIs, the CLI on
2 ranks, the DeepEnsemble sweep (at HEALPix-16, and at the shipped
HEALPix-64 configuration's own settings with 5 members), a year's free
run, the profiling harness and an experiment ingested from raw GRIB2
files, on the card and checks them, in phases printed one per line:

1. card      name and power limit (nvidia-smi); the allocator setting
             the port asks for before the first CUDA allocation
             (`_device.ask_expandable_segments`, as its entry points do)
2. build     the three CUDA kernels (all three include one header; the
             ELL kernel takes its mbarrier helpers), compiled side by side
             with nvcc from this checkout (seconds; registers, shared
             memory, spills); each holds a full-range and a row-range
             entry; the registers and spills of the block kernels'
             tensor-core instances (bf16 x; none may spill) and the count
             of HGMMA instructions in their SASS (cuobjdump; none may have
             0), and of their four gather-body instances (fp32 x); the
             registers and spills of the ELL kernel's three column-tile
             instances (none may spill)
3. parity    the super-row SpMM kernel (K1) and the plain-BCSR one (K3) at
             HEALPix-16 and HEALPix-64 level 0, fp32 and bf16, width 1024,
             against scipy `L @ x` (bars: fp32 < 1e-5, bf16 < 2e-2, max abs
             error / max abs) and against their plain PyTorch versions on
             the card; K3 at each width the main path gives it too, and in
             both regimes of fp32 A against bf16 x (`round_a`; False is
             K4's function) at HEALPix-16 and -64, and on a product whose
             exact output cancels (tests/torch_split_probe.py), where K4's
             hi + lo split must read under 2^-14 of max(|A||x|) and K3's
             A rounded to bf16 above it; the backward of both,
             d/dx sum((Lx)^2) against 2 L^T (L x) (bar 1e-5), for the knn L
             and for a non-symmetric D L (through the transposed super-row
             layout and the transposed plain layout);
             the row ranges alone (K2, and K3's): HEALPix-16 and -64 level
             0, width 1024, split 2 and 4 ways, each shard against the rows
             of the full launch (exactly), its plain version (exactly in
             the fp32-x regimes; at the bf16 bar with bf16 x, where the
             tensor cores sum in another order) and scipy's rows (bars as
             above): K2 in fp32 and bf16, K3 in fp32, bf16 and both
             regimes of fp32 A against bf16 x;
             the ELL kernel (`ell_spmm`, the fp32 route of every
             block-sparse operator: fp32 x against fp32 A, read through
             the layout's union tables; each reading names its blocks,
             largest union and the card's plan: column tile, shared
             memory, CTAs an SM), at HEALPix-16
             and -64 width 1024: the operator's matvec (one ELL launch)
             against scipy (1e-5), the kernel against its plain version
             (exactly: the same rounded products in the same order),
             timed beside K1's and K3's fp32 regime (the gather body),
             cuSPARSE and the bound of the function's own work (element
             nonzeros, bytes of x, y and the layout); its backward (2 L^T
             (L x), 1e-5) on the knn L and on the transposed layout of D L
             (K1 and K3 held on their own layouts too, the ELL taken
             away); its row ranges for 2 and 4 shards equal to the full
             launch's rows and the plain version, exactly, on both
             layouts; K5's fold of 2 members equal to one launch per
             member, exactly;
             the gather body (fp32 x: the block layouts' kernels over the
             nonzero entries of their listed blocks, `spmm_regime`) at
             HEALPix-16 and -64 level 0, width 1024: K1 and K3 with fp32
             and with bf16-stored A, K2's and K3's row ranges (units
             [0, n/2)), each against its plain version and scipy (1e-5),
             a range against the full launch's rows (exactly), then timed
             beside torch.sparse.mm on the same matrix and the bound of
             its work (the listed blocks, x and the output moved once;
             2 operations per element nonzero at the fp32 rate);
             phase mixed: K1 and K2 with fp32 A against bf16 x (the
             tensor cores, A rounded to bf16 in registers) at the same
             shapes, against the plain version and scipy with A rounded
             (2e-2), timed beside torch.sparse.mm (bf16) and the bound
4. slice     UNetSpherical, HEALPix-16, knn-20, max pool, increment
             learning, bf16, 7 features x 3 lags -> 2, seeded weights in
             the JAX layout loaded through `weights.py`, exported
             (`torch.export`, in process) behind ForecastService (batch
             16, block 2): a 20-step forecast of 16
             histories and 5 concurrent submit() requests; finite outputs
             of the right shapes, agreement with the same forward on the
             CPU plain path (3e-2; the CPU takes the card's ReLU and
             max-pool decisions, each that differs within 1e-2 of its
             kink or tie), 10 K1 launches per forward
5. train     the same model trained: AR6 (7 iterations, RNN strategy),
             area-weighted MSE, Adam(1e-3, eps=1e-7), a synthetic batch
             from np.random.default_rng:
             (1) batch 2, the first step's losses and every parameter
                 gradient on the card against the CPU plain path (3e-2,
                 per key; a one-element gradient against the sum of its
                 terms' magnitudes);
             (2) batch 16, 10 steps on one batch: finite losses, the last
                 below the first, exactly 70 forward and 68 backward K1
                 launches per step;
             (3) as (2) with the level-0 operator in plain BCSR
                 (`rows_per_super=0`): only K3, as many launches, first
                 loss within 3e-2 of (2)'s
6. train64   HEALPix-64 AR2 batch 8 bf16 (all three levels block-sparse),
             3 steps: finite, decreasing losses, 66 forward and 64 backward
             K1 launches per step; step time and peak device memory; then
             K1 on each level's operator at each width one step gives it
             (recorded during a step), forward and backward, against its
             plain version and scipy (bf16 bar), covering every shape the
             step launched K1 at
6b. train64f32 the shipped fp32 configuration
             Healpix_100km/MaxPool-Graph_knn through `models.get_model` at
             its own float32, full width and depth (49152 and 12288 nodes
             block-sparse: every product the ELL kernel's; 3072 dense), 3
             steps at train64's traffic (AR2, batch 8, RNN, area-weighted
             MSE, Adam eps 1e-7 with the config's clipping): finite,
             decreasing losses, exactly 54 forward and 52 backward ELL
             launches a step and no other kernel; step time, peak
             memory; one untimed step on K1's fp32 regime (the gather
             body; the ELL taken away: K1 alone); a forecast call (no grad, batch 8: 18 ELL
             launches); at each (level, width) shape of the step, per
             launch: the ELL kernel
             (exact vs its plain version, 1e-5 vs scipy forward and
             backward), K1's gather body (its wrapper on the operator's
             super-row arrays), cuSPARSE and the bound; one batch-1 AR1
             step card vs CPU (losses and every gradient at 1e-5, the CPU
             taking the card's decisions)
6c. shipped100km all 18 shipped Healpix_100km configurations (knn,
             voronoi and mesh Laplacians x max, avg, interp, maxarea,
             maxval and learned pools) through `models.get_model` at
             their own settings: fp32 HEALPix-64, levels 0-1 ELL and 2
             dense, batch 16, AR6 (RNN, area-weighted MSE), the config's
             lags [-18, -12, -6] and Adam at its lr with its clipping,
             no remat; seeded weights (learned logits too), synthetic
             inputs; per config 2 steps: finite losses, exactly 126
             forward and 124 backward ELL launches a step and no other
             kernel, the second step's time and its own peak memory
             (allocator readings), a forecast call (no grad, batch 16: 18
             launches); MaxPool-Graph_knn also with remat (first-step
             losses and gradients equal to the step without at 1e-5,
             peak and time beside it); 7 configs (voronoi, mesh, every
             pool) batch 1 AR1 card vs CPU at 1e-5; the ELL kernel at
             every shape the voronoi (L and L^T) and mesh steps launch it
             at: exact vs its plain version, 1e-5 vs scipy, ms per launch
             beside its bound and cuSPARSE
6d. ens64    (after the rank phases) the shipped Healpix_100km MaxPool knn
             configuration's DeepEnsemble at its own settings (fp32
             HEALPix-64, batch 16, AR6 RNN, lr 0.007, clipping 1.0) with
             remat. (a) The member step driven directly: 5 members (seeds
             1000 + m, the JAX package's default count) on one synthetic
             batch, 3 steps: exactly 126 + 250 ELL launches a step (K5
             folds the members into each launch: 5x the single remat
             step's widths but the first convolution's 4 on the shared
             batch) and no other kernel; member 0's first-step losses,
             gradients and parameters within 1e-4 of one single remat
             step on its weights (Adam eps 1e-3), the single step on
             member 0's ReLU and max-pool decisions (`steer`, each that
             differs within 1e-6 of its kink); one
             `utils.profiling.profile_step` of it: the second step timed
             (host clock), the third traced (device busy share, top
             device rows), their own peak at most 1.125 x 5 x
             shipped100km's reading of the single remat step's (taken
             in the same run); one step of the largest
             stack whose own peak, predicted per member, stays under 72
             GiB with what the card holds before it, on the allocator
             settings the port asks for (expandable segments: the
             script's first act is the entry points' own
             `_device.ask_expandable_segments`; the default segments
             fragment there), its peak against the prediction; the ELL kernel
             at the folded width x[49152, 5 x 2048] (exact vs its plain
             version, 1e-5 vs scipy, beside its bound and
             torch.sparse.mm). (b)
             `cli.experiments.run_deep_ensemble(member_parallel=True)`
             with 5 members on the same config (remat on; 1 epoch, short
             periods, scored every 2 updates) over a toy HEALPix-64 store
             from `cli.prepare_toy_data` (140 six-hour steps, seed 0,
             written on the host beside the rank phases), an
             AR4 forecast: every member store, the ensemble and median
             stores finite and of their shapes, the median's RMSE and the
             CRPS finite, only the ELL kernel launched, each checkpointed
             AR iteration recomputed once; seconds by stage
7. node16    the step of (2) on a 1 data x 2 node mesh: 2 spawned ranks
             (of the rank phases' one spawn, below) share the card over `gloo` (NCCL refuses two ranks on one
             device), each holding half the sphere at every level; 3
             steps: per-iteration losses within 3e-2 of (2)'s first
             steps, 70 forward + 68 backward K2 launches and no K1 launch
             per rank per step, 22 gathers per model call, parameters
             identical across ranks, step time (2 ranks sharing one H100:
             not a scaling number); then the fp32 batch-2 step (level 0
             block-sparse fp32: the ELL kernel's row range): every
             gradient against the
             single-process card step's, per key, at (1)'s bar
8. mesh16    the same model on 2 data x 2 node (4 ranks), one step: loss
             within 3e-2 of (2)'s first, the launches of node16,
             parameters identical across ranks; then node16's fp32 batch-2
             step on the same mesh: every gradient Adam steps on, reduced
             over both groups, against the single-process card step's
9. node64    the HEALPix-64 step on 1 x 2, 2 steps: losses within 3e-2 of
             train64's, 66 + 64 K2 launches per rank per step, peak memory
             per rank; K2 at every (level, width) one sharded step gives
             it, forward and backward, against its plain version and
             scipy's rows (bf16 bar)
10. times    ms per train step and samples/s (host clock ended by
             torch.cuda.synchronize(), one window of 2 steps, K1
             and K3 steps taken in turns); each kernel per launch
             (`device_ms`: a CUDA graph of launches replayed) at the main
             path's widths beside
             its bound, its plain version and cuSPARSE, and K3 in K4's
             regime (fp32 A, bf16 x [3072, 1024], `round_a_false` of K3's
             row); K2 and K3's row range on the node16 step's level-0
             shard; the layouts side by side: K1 and K3 (its plain layout
             built from the same Laplacian, held to its plain version and
             scipy) at each (level, width) shape of the HEALPix-64 step;
             K2 at each (level, width) shape of the node64 step beside
             its bound and cuSPARSE's CSR row slice (`node64_shapes` of
             K2's row); the ELL kernel's row: its train64f32 shapes, its
             parity readings and its row range

11. protocol16 the port's train -> predict -> verify CLI
             (`cli.train_predict.main`) on the flagship config
             (configs/UNetSpherical/Healpix_400km/MaxPool-Graph_knn.json,
             as prep16's `create_configs` wrote it) with numeric_precision
             bfloat16 and its epochs cut (full width and depth; K1 at level
             0), over prep16's toy HEALPix-16 data (1460 six-hour steps,
             seed 0): the
             device-cache path taken, K1 launched in the training forward
             and backward, validation and the AR20 prediction (and nothing
             else), every logged loss finite, the checkpoint and skill
             files written, the forecast store [n_frt, 21, 3072, 2]
             finite, RMSE larger at lead 20 than at lead 1 for both
             variables; then one --resume epoch. It prints the wall
             seconds of train, predict, rechunk and verify, the driver's
             training samples/s beside the bare step's (at the driver's AR
             depth, and phase train's AR6), AR20 seconds per reference
             time, peak device memory and K1's launches by part. It runs
             after the others: the config asks for deterministic training
             (torch.use_deterministic_algorithms, reset after it).
12. serve16  protocol16's trained flagship served from artifacts, two
             members: the experiment copied before its --resume epoch
             (1 epoch) and the resumed one (2). `cli.predict` of the
             resumed experiment, AR20 from 4 reference times: finite,
             lead 1 within the bf16 bar (2e-2) of the experiment's own
             forecast store, 10 K1 launches per forward; `cli.export_model`
             of each member alone and of both (`member_dirs`; batch 16,
             block 2), loaded from disk with the geometry builder made to
             raise; the resumed member's artifact behind ForecastService:
             its first block within 2e-2 of the in-process rollout of the
             same weights, a 20-step forecast of 16 histories and 5
             concurrent submit()s, exactly 10 K1 launches per forward; the
             2-member artifact: exactly 10 K1 launches per forward for both
             members (K5, the op's vmap rule), at twice the single
             artifact's widths, each member's first step within 2e-2 of
             its own single artifact (the first block's steps printed: the
             batched GEMMs round otherwise in bf16, and the feedback
             grows it), `summarize` finite; the HTTP server
             (`cli.serve.serve`, port 0): /healthz, /v1/meta and a POST
             within 2e-4 of svc.predict. It prints export and load seconds,
             the .pt2 sizes, the forecast step of both artifacts, the
             submit latency and the HTTP round trip, and times K5's one
             launch per product against the member loop it replaces
             (`k5_vmap_rule` under K1's row of the kernel line).
13. bn16     (run after phase 6) the flagship built with BatchNorm: 3
             `with_norm_state` steps (bf16, AR6, batch 16), exactly 70 + 68
             K1 launches each, the running statistics finite and moved by
             every step, the step time; one fp32 batch-2 step (level 0
             block-sparse) against the CPU with the card's decisions:
             losses, gradients and running statistics at 3e-2 (a norm bias
             that feeds another BatchNorm against its block's norm scale:
             its gradient cancels); `bn_update` over 2 toy batches, then
             an eval-mode 20-step forecast of 16 toy histories with those
             statistics: finite, 10 K1 launches per forward
14. ens16    (after bn16) 2 flagship members from two seeds
             (`models.MemberStack`) trained together, the member step
             (each AR iteration under `torch.func.vmap`, one backward,
             bf16, AR6, batch 16), 3 steps: exactly 70 + 68 K1 launches per step for both
             members, each at twice the single step's width but the 2
             products on the shared batch, the member step's time beside
             the single step's (phase train); one fp32 batch-2 member step
             against each member's single step on the card (1e-4: losses,
             gradients clipped by a bound between the members' norms, so
             one member clips, and parameters), the single steps taking
             the member step's ReLU and max-pool decisions (each that
             differs within 1e-6 of its kink or tie)
15. swag16   (after serve16) `cli.finetune_swag.main` on protocol16's
             resumed experiment: 1 epoch, 2 members, a collection every 2nd
             scoring, AR5 on the toy test period; K1's launches by part
             (fine-tune forward and backward, validation, member rollouts:
             their sum is every launch), `model_swag.npz` with 2 models or
             more, member and median stores [201, 6, 3072, 2] finite, the
             ensemble store, CRPS growing from lead 1 to lead 5; then
             `cli.export_model --swag_samples 2`: one block of the
             artifact, 10 K1 launches per forward at twice the single
             model's widths; fine-tune, per-member and export seconds.
16. grids400 (after swag16) six shipped configurations at their full
             400 km size and the shipped UNet widths (7 features x 3 lags
             -> 2), cut to bf16 (at the shipped fp32 every 400 km level is
             dense): Equiangular_400km/MaxPool-Graph_voronoi,
             Equiangular_400km_tropics/AvgPool-Graph_knn (odd dimensions),
             Icosahedral_400km/LearnPool-Graph_mesh (learned logits),
             Cubed_400km/MaxAreaPool-Graph_knn,
             O24/MaxValPool-Graph_voronoi (scatter unpool) and
             Healpix_400km/InterpPool-Graph_mesh, each built through
             `models.get_model` as the CLI builds it: its level sizes, the
             nonzero/total 128x128 blocks of level 0's forward layout (and
             of the transposed one for voronoi, whose backward runs it) and
             the geometry's host seconds (native remap overlaps; a fresh machine's
             disk cache is empty); 3 AR6
             batch-16 steps (RNN, area-weighted MSE, the port's Adam with
             eps 1e-7 and the config's clipping): finite, decreasing
             losses, exactly 70 + 68 K1 launches each, the step ms; K1 at
             every (layout, width) shape the step launched, forward and
             backward, against its plain version and scipy (bf16 bar); an
             fp32 batch-2 AR2 step on the card against the CPU with the
             card's ReLU and argmax-pool decisions (`steer`), per key at
             1e-5, learned logits included; a 20-step forecast of 16
             histories through ForecastService (10 K1 launches per
             forward). For O24 also K1 per launch on both layouts at the
             step's widths beside the bound and cuSPARSE. Then the O24
             config through `cli.train_predict.main` (bf16, 1 epoch, toy O24
             data, AR4 predict, verify: finite losses, store and RMSE) and
             `cli.export_model`, its artifact loaded with the geometry
             builder refused and its first step within the bf16 bar of the
             in-process rollout, after the remap pools' scatter and
             gather backward are shown to repeat bitwise under
             `torch.use_deterministic_algorithms` (the config asks for
             deterministic training); and each variant architecture
             (ResNetSpherical, EPDNetSpherical, DownscalingNetSpherical at
             HEALPix-16, ConvNetSpherical with conv_type='image' at
             Equiangular_400km): one bf16 forward and backward, finite,
             exactly the level-0 K1 launches its blocks give. It prints the
             phase's seconds, geometry (host) apart.
17. ensmesh16 (after remat16) 4 flagship members (bf16, AR6, batch 16)
             over member ranks, 4 spawned ranks sharing the card: the
             member step (`make_member_train_step(mesh)`) on 1 x 2 x 2 and
             on 2 x 1 x 2 (data x node x member), 2 steps each: every
             member's losses (gathered over the member group) within 3e-2
             of the single-process 4-member step's; on 1 x 2 x 2 exactly
             70 + 68 K2 launches a rank a step at ens16's 2-member widths
             (K5 over K2: both members of a rank folded into one launch a
             product) and 22 gathers a model call (one a product), on
             2 x 1 x 2 70 + 68 K1; each member's parameters identical on
             its data and node ranks; K2 at every (level, width) the
             member step launched, forward and backward, against its
             plain version and scipy's rows (bf16 bar); then
             `ensemble_rollout_predictions(mesh=)` of the 4 members on
             1 x 1 x 2 over a toy HEALPix-16 store: every rank's [4, ...]
             within the bf16 bar of one process's, 40 K1 launches a rank
             for its 2 members, 2 gathers.
18. bnmesh16 bn16's step on 2 x 1 and 1 x 2 (2
             ranks): 2 `with_norm_state` steps, the statistics over the
             whole mesh's batch: losses and running statistics within 3e-2
             of bn16's steps, the statistics identical on both ranks,
             70 + 68 K1 (2 x 1) or K2 (1 x 2) launches a step; the fp32
             batch-2 BatchNorm step on both meshes: every gradient Adam
             steps on against the single-process card step's, per key at
             3e-2 (a norm bias that feeds another BatchNorm against its
             block's norm scale).
19. gridsnode400 Equiangular_400km/MaxPool-Graph_voronoi
             and Cubed_400km/MaxAreaPool-Graph_knn on 1 x 2 (bf16, AR6,
             batch 16), 2 steps each: losses within 3e-2 of one process's
             steps, exactly 70 + 68 K2 launches a step, 26 gathers a model
             call (22 products, the 2 pools and 2 unpools gathering over
             the node group), parameters identical on both ranks; K2 at
             every step shape, forward and backward (voronoi: the
             transposed layout), against its plain version and scipy's
             rows; one bf16 forward and backward of ConvNetSpherical
             (`conv_type='image'`, Equiangular_400km) on 1 x 2: finite, 7
             gathers (one an image convolution), loss and gradients
             within 3e-2 of one process. Then K2 per launch
             (`device_ms`) at the member-folded level-0 widths and on the
             voronoi transposed layout, beside its bound, its plain
             version and cuSPARSE's CSR row slice (`member_folded`,
             `voronoi_transposed` under K2's row of the kernel line).
20. remat16  (after ens16) ens16's 2-member step with `remat=True` beside
             the same step without, on one weights and batch: exactly 208
             K1 launches a step with remat (the recompute repeats the 70
             forward products) and 138 without, no other kernel; peak
             device memory of a step of each beside the single model's
             AR6 step's: the member step's own peak at most 2.25x the
             single step's, and with remat at most 0.6x itself without;
             step time of each (in turns);
             the fp32 batch-2 member step with and without remat on the
             same ReLU and max-pool decisions (`steer`, every one equal),
             losses and every gradient within 1e-5. Inside ensmesh16's
             spawn, the 1 x 2 x 2 member step with remat: 208 K2 launches
             a step on each rank, 22 gathers in each of 14 model calls,
             losses within 3e-2 of the same ranks without remat and of one
             process, step time beside ensmesh16's.
21. prep16   (in a thread beside the rank phases, with ingest16's host
             stages and ens64's toy store in others) an experiment's
             data and configs built from nothing by the port's CLIs
             (host only): `prepare_toy_data` (HEALPix-16, 1460 six-hour
             steps, seed 0), `compute_scalers`,
             `compute_benchmarks` (5 leads), `create_configs` (108
             configs, each equal to the shipped one of its name); seconds
             and files of each stage. protocol16 trains on this data and
             config.
22. cli2rank (after prep16) `python -m
             deepsphere_weather_torch.cli.train_predict` on prep16's data
             with the flagship config at `n_node_parallel: 2` (bf16, 1
             epoch, AR1, short periods of the toy year, AR4 forecast):
             the CLI spawns its 2 ranks on gloo (they share the card);
             rc 0, the scored losses within 3e-2 and rank 0's RMSE within
             3e-3 of the same config on one process; every output written
             once, all by rank 0 (the write log of
             tests/write_log_site/sitecustomize.py, with each process's
             launch counters: K2 on both ranks, K1 in rank 0's prediction
             alone); wall seconds by stage.
23. ensemble16 (after swag16) `cli.experiments.run_deep_ensemble`, 2
             members in the member step with `remat: true`, on prep16's
             data and cli2rank's cut of the flagship config, AR4 forecast:
             AR iterations recomputed, only K1 launched, the ensemble and
             median stores, the median's RMSE and the CRPS finite; seconds
             by stage.
23b. xyear16 (after ensemble16) `cli.experiments.run_x_year_simulations`
             of protocol16's resumed flagship (bf16, K1 at level 0),
             `years=1` (the reference's 5 cut): 1461 steps at its six-hour
             forecast_cycle in blocks of 1000 and a tail of 461, from two
             reference times 13 and 7 steps before the store's end, so
             that the analytic TOA-solar generator forces every step past
             it: every lead written and finite, exactly 10 K1 launches a
             model call and no other kernel, the generator called for each
             (reference time, step) past the store, the device's peak over
             the run within 5% of its peak over the first block; seconds a
             step and the writer thread's share of the rollout's wall.
24. profile16 `utils.profiling.profile_step` of the flagship forward and
             train step with torch.profiler Chrome traces (the top device
             rows by name), `summarize_model`; `scalability_sweep` (fp32)
             over HEALPix-16 and -32 at knn 8 and 20: forward and forward
             + backward ms against nodes, exactly 636 ELL launches (level
             0 of HEALPix-32) and no other kernel.
25. ingest16 (last; its host stages in a thread beside the rank phases)
             raw GRIB2 to a verified experiment: a GRIB2 tree in the
             reference's layout (tests/torch_ingest_chain.py) on the
             ECMWF O32 grid (5248 points): z and t at 500 and 850 hPa and
             accumulated TOA solar radiation every 6 hours for 120 days,
             and topography, land-sea mask and soil type;
             `data.preprocess.remap_grib_files` onto HEALPix-16 (overlaps
             from the native library, no disk cache; soil type by largest
             area fraction), reformat, `zarrify_raw_data`,
             `rechunk_to_space_chunked`, the statics, `cli.compute_scalers`;
             then `cli.train_predict.main` with the flagship config cut as
             cli2rank's (bf16, full width and depth, K1 at level 0), AR4
             forecast, verification and plots. Checks: the native overlaps
             against their plain version on O8 -> HEALPix-4 (1e-12), the
             ingested z500 mean against the GRIB field's (2e-3), the
             native bulk chunk reader against the per-chunk Python path
             on the ingested stores (exactly), K1 launched and no other
             kernel, finite losses and RMSE; the figures written or the
             driver's `plots skipped` line; host seconds by stage and the
             GRIB bytes.

The rank phases 7-9 and 17-20 run in one spawn of 4 ranks, after remat16:
their single-process references first, then every task in turn on the
ranks its mesh uses (a 2-rank mesh leaves ranks 2 and 3 idle), then each
phase's checks. cli2rank (22) starts its own ranks. Host-only work
(prep16, ingest16's GRIB tree and remap, ens64's toy store) runs in
threads beside that spawn, so the phases' seconds overlap there, and
their host readings and the ranks' step times are taken under that
contention. Ranks are started
after the kernels are built, join a `gloo` process group with a timeout,
and the script waits for them with a limit; a rank that fails fails the
run. At its end the script prints each phase's wall seconds. Any failed phase raises, and the
script exits non-zero. The lines before the last are the kernel table as
JSON and the card; the last line is {"ok": true, "device": {...}}. Without
CUDA it exits non-zero at once.
`--profile` adds the device time by kernel of three forwards, of two
train steps with each level-0 kernel (K1, K3), of two HEALPix-64 steps
and two train64f32 steps (the ELL kernel's share among them),
and of two ens16 member steps beside two single steps on their batch.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import functools
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
SLICE_SUBDIV, BIG_SUBDIV, KNN = 16, 64, 20
# the block of every exported rollout (the slice's, serve16's, swag16's,
# grids400's): each export traces the block's model calls on the host (4
# until ingest16 came)
BATCH, BLOCK, N_STEPS, N_SUBMIT = 16, 2, 20, 5
F_DYN, F_BC, F_STATIC, INPUT_K = 2, 1, 4, (-3, -2, -1)
MATVEC_WIDTH = 1024
BARS = {"fp32": 1e-5, "bf16": 2e-2}
GRAD_BAR = 1e-5
SLICE_TOL = 3e-2
# the card-vs-CPU forward: a decision that differs must sit this close to
# its kink or tie (|x| or the max-pool gap, over the call's largest |x|),
# about a bf16 ulp of that |x| (2^-7 at most). Sound runs on an H100
# read up to 6.8e-3 at four seeds; one listed slot dropped from K1's list,
# 0.13 and more (scripts/torch_chip_readings.py gaps, PERF.md)
GAP_TOL = 1e-2
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12}   # fp32 non-tensor; bf16 dense
KERNEL, PLAIN_KERNEL = "bcsr_super_spmm", "bcsr_spmm"
ROW_KERNEL, PLAIN_ROW_KERNEL = "bcsr_super_spmm_rows", "bcsr_spmm_rows"
ELL_KERNEL, ELL_ROW_KERNEL = "ell_spmm", "ell_spmm_rows"
SOURCES = {KERNEL: "deepsphere_weather_torch/kernels/bcsr_super_spmm.cu",
           PLAIN_KERNEL: "deepsphere_weather_torch/kernels/bcsr_spmm.cu",
           ROW_KERNEL: "deepsphere_weather_torch/kernels/bcsr_super_spmm.cu",
           ELL_KERNEL: "deepsphere_weather_torch/kernels/ell_spmm.cu"}
REPLACES = {KERNEL: "deepsphere_weather_tpu/ops/pallas_spmm.py:493",
            PLAIN_KERNEL: "deepsphere_weather_tpu/ops/pallas_spmm.py:340 "
                          "(_spmm_kernel_dma); :327 (_spmm_kernel, "
                          "round_a=False)",
            ROW_KERNEL: "deepsphere_weather_tpu/ops/pallas_spmm.py:402",
            ELL_KERNEL: "deepsphere_weather_tpu/ops/pallas_spmm.py:493 "
                        "(_spmm_kernel_super_sched), :402 "
                        "(_spmm_kernel_super) and :340 (_spmm_kernel_dma), "
                        "their fp32 regime"}
# Block-sparse products per model call, from the channel plan
# (models/unet.py) and cheb_conv's K - 1 = 2 products per convolution:
# level 0 holds 5 convolutions (conv1 x2, uconv1 x2, uconv1_final), level
# 1 four (conv2, uconv2), level 2 two (conv3).
PRODUCTS_PER_LEVEL = (10, 8, 4)
LAUNCHES_PER_FORWARD = PRODUCTS_PER_LEVEL[0]
# The first convolution of AR iteration 0 acts on the raw input, which
# needs no gradient: its two products get no backward.
NO_GRAD_PRODUCTS = 2
# level-0 product widths per sample: conv1 (21 -> 64 -> 128, input side),
# uconv1 (256 -> 128 -> 64, Clenshaw), uconv1_final (64 -> 2, Clenshaw)
WIDTH_FEATURES = (21, 64, 128, 64, 2)
TRAIN_AR, TRAIN_CHECK_BATCH, TRAIN_STEPS = 6, 2, 10
HP64_AR, HP64_BATCH, HP64_STEPS = 2, 8, 3
# train64f32: the shipped fp32 HEALPix-64 configuration at train64's
# traffic; its card-vs-CPU step's AR depth and batch; the forecast
# forwards timed
F32_CONFIG = "Healpix_100km/MaxPool-Graph_knn"
F32_CHECK_AR, F32_CHECK_BATCH, F32_FORWARDS = 1, 1, 5
# the train steps' timing: best of TIME_WINDOWS windows of TIME_STEPS
# chained steps (`time_steps`' default, kept by scripts/torch_chip_readings.py
# so that its A/B runs compare like with like); the smoke's own phases take
# windows of SMOKE_STEPS steps, SMOKE_WINDOWS of them where a phase sets no
# count (4 x 4 until shipped100km came, 2 x 2 until ens64 and xyear16
# came: the smoke stays inside its time limit; these readings are not
# comparable with 4 x 4 or 2 x 2 ones)
TIME_WINDOWS, TIME_STEPS = 4, 4
SMOKE_WINDOWS, SMOKE_STEPS = 1, 2
# shipped100km: the shipped Healpix_100km configurations (every graph type
# and pool) at their own settings; steps per config; the configs held card
# vs CPU (the new Laplacians, and the new pools at 49152 nodes); the one
# also trained with remat; those whose ELL shapes are timed; its forecast
# calls timed
SHIPPED_DIR, SHIPPED_STEPS = "Healpix_100km", 2
SHIPPED_CHECK = ("MaxPool-Graph_voronoi", "MaxPool-Graph_mesh",
                 "AvgPool-Graph_knn", "InterpPool-Graph_knn",
                 "MaxAreaPool-Graph_knn", "MaxValPool-Graph_knn",
                 "LearnPool-Graph_knn")
SHIPPED_REMAT = "MaxPool-Graph_knn"
SHIPPED_SHAPES = ("MaxPool-Graph_voronoi", "MaxPool-Graph_mesh")
SHIPPED_FORWARDS = 1
LR, ADAM_EPS = 1e-3, 1e-7
# ens64: the shipped Healpix_100km MaxPool knn configuration's
# DeepEnsemble (members, the JAX package's default 5, drawn from seeds
# ENS64_SEED + m as `run_deep_ensemble` seeds them) at its own settings
# with remat; the member step's own peak against M single remat steps'
# (remat16's 2.25 bar at 2 members, per member) and the largest stack's
# budget (90% of the card's 80 GB); (b)'s toy HEALPix-64 store (six-hour
# steps), the periods it trains, validates and forecasts on (the config's
# window spans 18 + 6 x 6 steps) and its scoring interval
ENS64_CONFIG = f"{SHIPPED_DIR}/{SHIPPED_REMAT}"
ENS64_MEMBERS, ENS64_SEED = 5, 1000
ENS64_PEAK_BAR, ENS64_BUDGET_GIB = 1.125, 72.0
ENS64_STORE_STEPS, ENS64_SCORING = 140, 2
ENS64_PERIODS = {"training_period": ["2010-01-01", "2010-01-14"],
                 "validation_period": ["2010-01-14", "2010-01-25"],
                 "test_period": ["2010-01-25", "2010-02-05"]}
# node- and data-parallel phases: steps, the fp32 check's level-0 threshold
# (so that level 0 stays block-sparse in fp32), the process-group timeout
# and each phase's limit (seconds)
NODE16_STEPS, MESH16_STEPS, NODE64_STEPS = 3, 1, 2
FP32_DENSE_THRESHOLD = 2048
PG_TIMEOUT_S, RANKS_LIMIT_S = 300, 900
# protocol16: the shipped flagship config through the CLI, bf16, epochs cut
# to about 5 s of training on an H100 (12 until the swag16 phase came, 6
# until grids400, 4 until the phases of remat, the CLIs on 2 ranks, data
# preparation, profiling and the ensemble sweep, 2 until ingest16: the
# script stays inside its time limit); AR20 forecasts
PROTOCOL_CONFIG = "configs/UNetSpherical/Healpix_400km/MaxPool-Graph_knn.json"
PROTOCOL_EPOCHS, PROTOCOL_AR_PREDICT = 1, 20
PROTOCOL_INPUT_K, PROTOCOL_CYCLE = (-18, -12, -6), 6
# serve16: reference times of cli.predict; the HTTP answer's bar against
# svc.predict (the JAX package's serving test's)
SERVE_FRTS, HTTP_TOL = 4, 2e-4
# bn16: with_norm_state steps; bn_update's toy store (six-hour steps) and
# its batches
BN_STEPS, BN_UPDATE_STEPS, BN_UPDATE_BATCHES = 3, 80, 2
# ens16: members, member steps, the fp32 member-vs-single bar and the
# Adam eps of that check: Adam's first step is lr g / (|g| + eps), so with
# eps 1e-7 an element whose gradient is rounding-small steps by up to lr
# in whichever direction its rounding gives (3.8e-4 of uconv2.res_kernel,
# H100, 700 W); with 1e-3 the step follows the gradient
ENS_MEMBERS, ENS_STEPS, ENS_TOL, ENS_CHECK_EPS = 2, 3, 1e-4, 1e-3
# remat16: the bar of the fp32 member step with remat against the step
# without (the same decisions, the same kernels); its timing windows
REMAT_TOL, REMAT_WINDOWS = 1e-5, 1
# remat16's memory bars: the 2-member step's own peak against the single
# model's step (the JAX package's member step holds 2.00x), and the member
# step with remat against itself without (the single step's cut)
MEMBER_PEAK_BAR, REMAT_PEAK_BAR = 2.25, 0.6
# cli2rank and ensemble16: prep16's flagship config cut to a short run
# (`_short_config`): the toy year's periods it trains, validates and
# forecasts on, its scoring interval (the period's 14 updates an epoch
# would score none at the shipped 30), the forecast's AR depth, and rank
# 0's RMSE bar against one process (protocol16's skill-curve bar)
CLI_PERIODS = {"training_period": ["2010-01-01", "2010-03-01"],
               "validation_period": ["2010-03-01", "2010-03-15"],
               "test_period": ["2010-04-01", "2010-04-14"]}
CLI_SCORING, CLI_AR_PREDICT, RMSE_TOL = 5, 4, 3e-3
# xyear16: protocol16's model in a free run of XYEAR_YEARS years (the
# reference's 05_exp_X_year_sims.py runs 5), from the reference times this
# many six-hour steps before its store's end; the device's peak over the
# run against its peak over the first block
XYEAR_YEARS, XYEAR_FRTS, XYEAR_MEM_TOL = 1, (13, 7), 0.05
# prep16: the benchmark forecasts' leads (the CLI's default 39 took 33 s
# on the card machine's host, 20 took 21 s; cut to 5 to make room for
# ingest16)
PREP_LEADS = 5
# profile16: the device rows printed per profile, the sweep's samplings
# and knn values, the node count above which an fp32 level is block-sparse
PROFILE_TOP = 12
SWEEP_SUBDIVS, SWEEP_KNN, FP32_DENSE_LIMIT = (16, 32), (8, 20), 8192
# swag16: members predicted and their AR depth (3 members at AR20 until the
# phases of remat and the CLIs came: each AR20 member cost about 26 s; AR10
# 16 s, cut to AR5 to make room for ingest16), collection every
# SWAG_FREQ-th scoring, members of the exported artifact
SWAG_SAMPLES, SWAG_AR_PREDICT, SWAG_FREQ, SWAG_EXPORT = 2, 5, 2, 2
# grids400: six shipped configurations at their full 400 km size and the
# shipped UNet widths, cut to bf16 (at the shipped fp32 every 400 km level
# is dense and no kernel runs): all six pool methods, all three graph
# types, six of the seven sampling directories. Per configuration:
# bf16 AR6 batch-16 steps, the AR depth of the fp32 card-vs-CPU step; the
# bar of the fp32 check's differing decisions (fp32 rounding of their
# kink or tie, as tests/test_torch_cuda.py holds it)
GRIDS400 = ("Equiangular_400km/MaxPool-Graph_voronoi",
            "Equiangular_400km_tropics/AvgPool-Graph_knn",
            "Icosahedral_400km/LearnPool-Graph_mesh",
            "Cubed_400km/MaxAreaPool-Graph_knn",
            "O24/MaxValPool-Graph_voronoi",
            "Healpix_400km/InterpPool-Graph_mesh")
GRIDS_STEPS, GRIDS_CHECK_AR = 3, 2
KINK_TOL = 1e-6
# the step's timing windows (the phase stays near 150 s); the CLI
# configuration, the six-hour steps of its toy store (1000 until ingest16
# came) and its epochs, scored every CLI_SCORING updates as cli2rank's
GRIDS_TIME_WINDOWS = 1
GRIDS_CLI, GRIDS_CLI_STEPS, GRIDS_CLI_EPOCHS = (
    "O24/MaxValPool-Graph_voronoi", 400, 1)
# level-0 block-sparse products of one forward of each variant (2 per
# convolution at level 0) and those of them on the raw input, which get
# no backward: ResNet 20 + 5 convolutions, EPDNet 2 + 12 + 2,
# DownscalingNet 3 at the fine level (its input is the coarse level's);
# ConvNetSpherical convolves images, with no operator
VARIANTS = {"ResNetSpherical": (50, 2), "EPDNetSpherical": (32, 2),
            "DownscalingNetSpherical": (6, 0), "ConvNetSpherical": (0, 0)}
GATHERS_PER_FORWARD = sum(PRODUCTS_PER_LEVEL)
# ensmesh16, bnmesh16, gridsnode400 (ranks sharing the card over gloo):
# the members of the member meshes (data x node x member) and their steps;
# the rollout's member ranks, its toy store's six-hour steps, its steps
# and reference times; the BatchNorm meshes (data x node); two grids400
# configurations on 1 x 2, whose UNet calls each gather before their 2
# pools and 2 unpools
MESH_MEMBERS, MESH_STEPS = 4, 2
ENSMESH = ((1, 2, 2), (2, 1, 2))
ENSMESH_ROLLOUT_MEMBERS, ENSMESH_STORE_STEPS = 2, 40
ENSMESH_ROLL, ENSMESH_T0S = 4, (5, 9, 13, 17)
BNMESH = ((2, 1), (1, 2))
GRIDSNODE = ("Equiangular_400km/MaxPool-Graph_voronoi",
             "Cubed_400km/MaxAreaPool-Graph_knn")
POOL_GATHERS = 4
# ingest16: the GRIB tree (ECMWF octahedral O32: 5248 points), its six-hour
# steps (120 days from 2010-01-01: CLI_PERIODS' training, validation and
# forecast periods at the flagship's 3 input lags), the registry name the
# phase gives it (the dataset registry has no O32 entry), the sampling name
# of its remapped tree, the small pair of the native-vs-plain check (O8 ->
# HEALPix-4) and its bar, and the conservativity bar of
# tests/test_ingest.py
INGEST_O, INGEST_STEPS = 32, 480
INGEST_DATASET, INGEST_SAMPLING_NAME = "ERA5_O32_TOY", "Healpix_400km"
INGEST_PAIR = (("gauss", 16, 8), ("healpix", {"subdivisions": 4,
                                              "nest": True}))
NATIVE_TOL, CONSERVE_TOL = 1e-12, 2e-3
# seeded ReZero weights are scaled by this for training: at U(0.5, 1.5)
# the random network's rollout grows several-fold per iteration
TRAIN_REZERO_SCALE = 0.1
# torch-only helpers shared with the port's card tests
# (tests/torch_steer.py, tests/torch_grad_terms.py)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


# wall seconds of each phase in this run (`clocked`), printed at its end
PHASE_SECONDS = {}
# temporary directories of the run, removed at its end (`main`)
TEMP_ROOTS = []


def clocked(fn):
    """The phase `fn`, its wall seconds added to PHASE_SECONDS under its
    name without the `phase_` prefix."""
    name = fn.__name__.removeprefix("phase_")

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                                   + time.perf_counter() - t0)
    return run


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def time_ms(fn, n_iter=20, n_warm=3):
    """Mean device time of fn() over n_iter calls (CUDA events)."""
    import torch

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n_iter):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n_iter


def device_ms(fn, n_iter=20, n_warm=3):
    """Mean device time of fn() over n_iter calls captured in one CUDA
    graph and replayed: no host enqueue between the calls, which would
    outlast a launch of a few microseconds and be timed instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(n_warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    t1.synchronize()
    del graph
    return t0.elapsed_time(t1) / n_iter


def host_ms(fn, n_iter=200):
    """Host time of one call of fn, its enqueue alone: the device keeps
    up with these launches, so the host clock does not wait on it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / n_iter


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


@clocked
def phase_build():
    from deepsphere_weather_torch.kernels.build import _nvcc, load_kernels

    t0 = time.perf_counter()
    for k in load_kernels([KERNEL, PLAIN_KERNEL, ELL_KERNEL]):
        log("build", f"{k.name}: {'built' if k.built else 'loaded from cache'}"
                     f" ({k.path.name}), nvcc {k.nvcc_seconds:.1f} s")
        # one line per distinct report (each template instance repeats it)
        for line in dict.fromkeys(k.ptxas_log.splitlines()):
            if "registers" in line or "spill" in line:
                log("build", f"{k.name} ptxas: " + line.strip())
    log("build", f"the three kernels in {time.perf_counter() - t0:.1f} s")
    # the bf16-x instances of both kernels must run on the tensor cores,
    # unspilled
    for name, body in ((KERNEL, "bcsr_super_spmm_tc"),
                       (PLAIN_KERNEL, "bcsr_spmm_tc")):
        check_tc_instances(load_kernels([name])[0], body, _nvcc())
        check_gather_instances(load_kernels([name])[0])
    check_ell_instances(load_kernels([ELL_KERNEL])[0])


def _ptxas_instances(k):
    """{instance: (registers, spill bytes)} from library k's ptxas log."""
    regs, spills, fn = {}, {}, None
    for line in k.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "bytes spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            spills[fn] = int(m[1]) + int(m[2])
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = int(line.split("Used")[1].split()[0])
    return {f: (r, spills.get(f, 0)) for f, r in regs.items()}


def check_gather_instances(k):
    """The registers and spills of a block kernel's gather-body instances
    (fp32 x; fp32 and bf16 A, 4 and 1 float4s a lane; ptxas, when built in
    this run): raises if one is missing. Their spills are printed, not
    refused: at 2 CTAs an SM (128 registers) the 16 gathers in flight of
    the 4-float4 instance spill some bytes, and measured faster than 8
    unspilled (PERF.md)."""
    if not k.built:
        return
    got = {f: v for f, v in _ptxas_instances(k).items() if "_gather" in f}
    log("build", f"{k.name} gather-body instances (fp32 x; fp32, bf16 A; "
                 f"4, 1 float4s a lane): registers "
                 f"{[r for r, _ in got.values()]}, spill bytes "
                 f"{[b for _, b in got.values()]}")
    if len(got) != 4:
        raise AssertionError(f"{k.name}: gather instances {got} (4 wanted)")


def check_ell_instances(k):
    """The registers and spills of the ELL kernel's column-tile instances
    (ptxas, when built in this run): raises if one spills."""
    if not k.built:
        return
    got = {f: v for f, v in _ptxas_instances(k).items()
           if "ell_spmm_kernel" in f}
    log("build", f"{k.name} instances (column tiles 16, 32, 64): registers "
                 f"{[r for r, _ in got.values()]}, spill bytes "
                 f"{[b for _, b in got.values()]}")
    if len(got) != 3 or any(b for _, b in got.values()):
        raise AssertionError(f"{k.name}: instances {got} (3, none spilled "
                             "wanted)")


def check_tc_instances(k, body, nvcc):
    """The registers and spills (ptxas) and the HGMMA count (cuobjdump
    -sass) of library k's instances of the tensor-core kernel `body`:
    raises if one spills or has no HGMMA instruction."""
    inst = _ptxas_instances(k)
    regs = {f: r for f, (r, _) in inst.items()}
    spills = {f: b for f, (_, b) in inst.items()}
    for line in k.ptxas_log.splitlines():
        if "wgmma" in line:     # e.g. ptxas serialising the wgmma
            log("build", f"{k.name} ptxas: " + line.strip())
    tc_fns = [f for f in regs if body in f]
    if k.built:
        log("build", f"{k.name} tensor-core instances ({body}): registers "
                     f"{[regs[f] for f in tc_fns]}, spill bytes "
                     f"{[spills.get(f, 0) for f in tc_fns]}")
        if not tc_fns or any(spills.get(f, 0) for f in tc_fns):
            raise AssertionError(f"{k.name}: a tensor-core instance spills "
                                 f"({spills})")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         str(k.path)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    tc = {f: n for f, n in counts.items() if body in f}
    log("build", f"{k.name} HGMMA instructions in the SASS of its "
                 f"tensor-core instances: {sorted(tc.values())}; elsewhere "
                 f"{sum(counts.values()) - sum(tc.values())}")
    if not tc or 0 in tc.values():
        raise AssertionError(f"{k.name}: a tensor-core instance has no "
                             f"HGMMA instruction ({tc})")


# ---------------------------------------------------------------------------
# One kernel against its plain version, and its bound
# ---------------------------------------------------------------------------

def _layout(op):
    """(kernel name, A blocks, block-column table, slot list or None) of
    op's forward product."""
    kind, a, idx, nz = op.forward_layout()
    return (KERNEL if kind == "super" else PLAIN_KERNEL), a, idx, nz


def _kernel_fns(name):
    from deepsphere_weather_torch.ops import bcsr

    if name == KERNEL:
        return bcsr.bcsr_super_spmm, bcsr.bcsr_super_spmm_reference
    return bcsr.bcsr_spmm, bcsr.bcsr_spmm_reference


def _bound(a, x, nnz_blocks, x_blocks, out_rows=None):
    """(bytes ms, operations ms) of L @ x at x's own, unpadded shape: the
    nonzero 128x128 blocks of A, the x rows they read (`x_blocks`
    128-row blocks) and the output (`out_rows` rows, x's by default) each
    moved once over HBM; the nonzero block products at the type's peak
    rate. The least time the card could take is the larger of the two."""
    import torch

    n, m = x.shape
    dt = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    out_size = 2 if dt == "bf16" else 4
    out_rows = n if out_rows is None else out_rows
    x_rows = min(x_blocks * 128, n)
    nbytes = (nnz_blocks * 128 * 128 * a.element_size()
              + x_rows * m * x.element_size() + out_rows * m * out_size)
    ops = 2.0 * nnz_blocks * 128 * 128 * m
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS[dt]


def _gather_bound(a, x, nnz_blocks, x_blocks, out_rows=None):
    """(bytes ms, operations ms) of the gather body's work (fp32 x: the
    nonzero entries of the listed blocks alone): the listed 128x128
    blocks read once, the x rows they read (`x_blocks` 128-row blocks)
    and the output (`out_rows` rows, x's by default, fp32) each moved once
    over HBM; 2 operations per element nonzero of A and column at the fp32
    rate without tensor cores. The least time the card could take is the
    larger of the two."""
    n, m = x.shape
    out_rows = n if out_rows is None else out_rows
    x_rows = min(x_blocks * 128, n)
    nbytes = (nnz_blocks * 128 * 128 * a.element_size()
              + (x_rows + out_rows) * m * 4)
    ops = 2.0 * int((a != 0).sum()) * m
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS["fp32"]


def _block_counts(name, a, idx):
    """(nonzero 128x128 blocks, block slots, distinct block-columns of x
    the nonzero blocks read) of a super-row (`name` KERNEL) or plain
    layout's A blocks and block-column table."""
    if name == KERNEL:
        n_s, R, bs, ubs = a.shape
        blocks = a.view(n_s, R, bs, ubs // bs, bs).transpose(2, 3)
    else:
        blocks = a
    nz = (blocks != 0).flatten(start_dim=blocks.dim() - 2).any(dim=-1)
    # super-row: a slot's column is read if any of its R rows is nonzero
    cols_read = idx[nz.any(dim=1)] if name == KERNEL else idx[nz]
    return int(nz.sum()), nz.numel(), int(cols_read.unique().numel())


def _csr(L, device, dtype):
    import torch

    L = L.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(L.indptr.astype(np.int64)),
        torch.from_numpy(L.indices.astype(np.int64)),
        torch.from_numpy(L.data), size=L.shape, device=device, dtype=dtype)


def measure(op, L, x, device, label, round_a=True, timed=True,
            plain_timed=True):
    """Kernel vs plain version on the same padded input, held to the bar
    of x's dtype (raises if it breaks it); times (`device_ms`) and bound."""
    import torch

    name, a, idx, nz = _layout(op)
    kernel, plain = _kernel_fns(name)
    kw = {"nz": nz} if name == KERNEL else {"nz": nz, "round_a": round_a}
    n, m = x.shape
    x_pad = torch.nn.functional.pad(x, (0, (-m) % 128, 0, op.rows - n))
    y = kernel(a, idx, x_pad, **kw)
    ref = plain(a, idx, x_pad, **kw)
    bar = BARS["bf16" if x.dtype == torch.bfloat16 else "fp32"]
    err_plain = _rel_err_card(y.float(), ref.float())
    if not err_plain < bar:
        raise AssertionError(f"{label}: {name} vs plain version "
                             f"{err_plain:.3e} breaks the {bar:g} bar")
    res = {"max_abs_err": float((y.float() - ref.float()).abs().max()),
           "rel_err_plain": err_plain, "y": y[:n, :m]}
    if not timed:
        return res
    # the library's call for the same function: fp32 A kept against bf16 x
    # (K4's regime) is fp32 CSR against x widened to fp32 (fp32 out)
    lib_dt = (torch.float32 if name != KERNEL and not round_a
              and a.dtype == torch.float32 else x.dtype)
    csr, x_lib = _csr(L, device, lib_dt), x.to(lib_dt)
    nnz, slots, x_blocks = _block_counts(name, a, idx)
    # fp32 x runs the gather body (A's nonzero entries), bf16 x the
    # tensor cores (whole blocks)
    t_bytes, t_ops = (_gather_bound if x.dtype == torch.float32
                      else _bound)(a, x, nnz, x_blocks)
    res.update({
        "blocks_nonzero": f"{nnz}/{slots}", "x_blocks": x_blocks,
        "ms": device_ms(lambda: kernel(a, idx, x_pad, **kw)),
        "host_ms": host_ms(lambda: kernel(a, idx, x_pad, **kw)),
        "plain_ms": (device_ms(lambda: plain(a, idx, x_pad, **kw), n_iter=5)
                     if plain_timed else None),
        "library_ms": device_ms(lambda: torch.sparse.mm(csr, x_lib)),
        "library_dtype": str(lib_dt).replace("torch.", ""),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "ops_ms": t_ops})
    return res


def _fmt(res):
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in res.items() if k != "y" and v is not None)


def _ell_bound(vals, cols, x, out_rows=None):
    """(bytes ms, operations ms) of the function L @ x over L's element
    nonzeros, whatever kernel computes it: the x rows the nonzeros read,
    the output (`out_rows` rows, x's by default) and the ELL layout (vals
    and cols, [rows, W]) each moved once over HBM; 2 operations per
    element nonzero and column at the fp32 rate without tensor cores."""
    n, m = x.shape
    out_rows = n if out_rows is None else out_rows
    nonzero = vals != 0
    x_rows = int(cols[nonzero].unique().numel())
    nbytes = (x_rows + out_rows) * m * 4 + vals.numel() * 8
    ops = 2.0 * int(nonzero.sum()) * m
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS["fp32"]


def measure_ell(ell, L, x, device, label, timed=True, plain_timed=True):
    """The ELL kernel on `ell`'s forward layout (an `EllOperator`)
    against its plain version on the same input: exactly (the same
    rounded products in the same order; raises otherwise); timed, per
    launch (`device_ms`) beside the bound of the function's own work
    (`_ell_bound`), its plain version and cuSPARSE's fp32 CSR product,
    with the union tables' shape and the launch's plan (`ell_plan`)."""
    import torch

    from deepsphere_weather_torch.ops import bcsr

    vals, cols, tables = ell.vals, ell.cols, ell.tables
    n, m = x.shape
    x_pad = torch.nn.functional.pad(x, (0, (-m) % 4)).contiguous()
    y = bcsr.ell_spmm(vals, cols, x_pad, tables)
    ref = bcsr.ell_spmm_reference(vals, cols, x_pad)
    err = float((y - ref).abs().max())
    if err:
        raise AssertionError(f"{label}: {ELL_KERNEL} vs plain version max "
                             f"abs error {err:.3e} (must be 0)")
    res = {"max_abs_err": err, "y": y[:, :m]}
    if not timed:
        return res
    csr = _csr(L, device, torch.float32)
    t_bytes, t_ops = _ell_bound(vals, cols, x_pad)
    res.update({
        "ms": device_ms(lambda: bcsr.ell_spmm(vals, cols, x_pad, tables)),
        "host_ms": host_ms(lambda: bcsr.ell_spmm(vals, cols, x_pad, tables)),
        "plain_ms": (device_ms(lambda: bcsr.ell_spmm_reference(
            vals, cols, x_pad), n_iter=5) if plain_timed else None),
        "library_ms": device_ms(lambda: torch.sparse.mm(csr, x)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "ops_ms": t_ops,
        "ell_width": int(vals.shape[1]),
        # how the launch ran: the union tables' blocks and the card's plan
        "blocks": int(tables.blocks.shape[1] - 1), "union_max": tables.umax,
        "block_rows_max": tables.rmax,
        **bcsr.ell_plan(tables, vals.shape[1], x_pad.shape[1])})
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return res


# ---------------------------------------------------------------------------
# Parity
# ---------------------------------------------------------------------------

# the parity phases' operators (phase_parity, phase_gather, phase_mixed),
# built once by (subdiv, A's dtype, rows_per_super); phase_mixed drops them
_PARITY_OPS = {}


def _parity_op(subdiv, L, dtype, rps, device):
    """BlockSparseOperator.from_scipy(L, ...) of HEALPix-`subdiv`'s
    Laplacian L, shared by the parity phases."""
    from deepsphere_weather_torch.ops.bcsr import BlockSparseOperator

    key = (subdiv, str(dtype), rps)
    if key not in _PARITY_OPS:
        _PARITY_OPS[key] = BlockSparseOperator.from_scipy(
            L, dtype=dtype, rows_per_super=rps, device=device)
    return _PARITY_OPS[key]


def _laplacian(subdiv):
    from deepsphere_weather_torch.models.geometry import cached_graph_laplacian

    return cached_graph_laplacian(
        "healpix", {"subdivisions": subdiv, "nest": True}, KNN, "knn")[1]


@clocked
def phase_parity(device, subdivs, width):
    """K1 and K3 forward against scipy and their plain versions, each
    kernel's own output, timed beside cuSPARSE and the bound (fp32 x: the
    gather body); in fp32 also the route the operator takes (`matvec`: the
    ELL kernel) against scipy, and the ELL kernel against its plain
    version, timed beside K1's and K3's gather body, cuSPARSE and the
    bound. Returns the ELL readings by shape and K1's and K3's fp32
    readings ({kernel: {shape: reading}})."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import launch_counts

    rng = np.random.default_rng(SEED)
    errs, ell_rows, block_fp32 = [], {}, {KERNEL: {}, PLAIN_KERNEL: {}}
    for subdiv in subdivs:
        t0 = time.perf_counter()
        L = _laplacian(subdiv)
        x_np = rng.standard_normal((L.shape[0], width)).astype(np.float32)
        ref = L @ x_np
        log("parity", f"HEALPix-{subdiv}: {L.shape[0]} nodes, graph + scipy "
                      f"reference {time.perf_counter() - t0:.1f} s")
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = torch.from_numpy(x_np).to(device, dt)
            gather = {}
            for rps in (2, 0):
                op = _parity_op(subdiv, L, dt, rps, device)
                kname = _layout(op)[0]
                res = measure(op, L, x, device, f"HEALPix-{subdiv} {name}")
                err = rel_err(res["y"].float().cpu().numpy(), ref)
                gather[kname] = res
                if dt == torch.float32:
                    block_fp32[kname][f"x{L.shape[0]}_{width}"] = {
                        "regime": "gather", "rel_err_scipy": err,
                        **{k: v for k, v in res.items() if k != "y"}}
                log("parity", f"{kname} HEALPix-{subdiv} {name} x[{L.shape[0]}"
                              f", {width}] A {tuple(_layout(op)[1].shape)}: "
                              f"rel err vs scipy {err:.3e} (bar "
                              f"{BARS[name]:g}), " + _fmt(res))
                if not err < BARS[name]:
                    raise AssertionError(
                        f"{kname} HEALPix-{subdiv} {name}: vs scipy "
                        f"{err:.3e} breaks the {BARS[name]:g} bar")
                errs.append(f"{kname} HEALPix-{subdiv} {name} {err:.3e} / "
                            f"{res['max_abs_err']:.3e}")
            if dt != torch.float32:
                continue
            # the fp32 route: the operator's matvec launches the ELL kernel
            before = dict(launch_counts)
            with torch.no_grad():
                y = op.matvec(x)
            launched = {k: v - before[k] for k, v in launch_counts.items()
                        if v != before[k]}
            if launched != {ELL_KERNEL: 1}:
                raise AssertionError(f"HEALPix-{subdiv} fp32 matvec launched "
                                     f"{launched}, not one {ELL_KERNEL}")
            err = rel_err(y.cpu().numpy(), ref)
            label = (f"{ELL_KERNEL} HEALPix-{subdiv} fp32 x[{L.shape[0]}, "
                     f"{width}]")
            res = measure_ell(op.ell, L, x, device, label)
            if not err < BARS["fp32"]:
                raise AssertionError(f"{label}: vs scipy {err:.3e} breaks the "
                                     f"{BARS['fp32']:g} bar")
            k1, k3 = gather[KERNEL], gather[PLAIN_KERNEL]
            res.update({"rel_err_scipy": err, "k1_fp32_ms": k1["ms"],
                        "k3_fp32_ms": k3["ms"]})
            ell_rows[f"x{L.shape[0]}_{width}"] = {
                k: v for k, v in res.items() if k != "y"}
            log("parity", f"{label} (ELL [{L.shape[0]}, {res['ell_width']}]):"
                          f" rel err vs scipy {err:.3e} (bar "
                          f"{BARS['fp32']:g}), vs plain version max abs "
                          f"{res['max_abs_err']:.3e}; {res['ms']:.4f} ms per "
                          f"launch (host enqueue {res['host_ms']:.4f} ms), "
                          f"bound {res['bound_ms']:.4f} ms by "
                          f"{res['bound_by']} (share "
                          f"{res['share_of_bound']:.3f}), plain "
                          f"{res['plain_ms']:.4f} ms, cuSPARSE "
                          f"{res['library_ms']:.4f} ms, the gather body "
                          f"{KERNEL} {k1['ms']:.4f} ms / {PLAIN_KERNEL} "
                          f"{k3['ms']:.4f} ms; cuSPARSE / ELL "
                          f"{res['library_ms'] / res['ms']:.2f}, {KERNEL} / "
                          f"ELL {k1['ms'] / res['ms']:.2f}")
            errs.append(f"{ELL_KERNEL} HEALPix-{subdiv} fp32 {err:.3e} / "
                        f"{res['max_abs_err']:.3e}")
    log("parity", "rel err vs scipy / max abs err vs plain version: "
                  + "; ".join(errs))
    return ell_rows, block_fp32


def _verdict(r):
    """A reading's time beside torch.sparse.mm's and its bound."""
    return (f"{r['ms']:.4f} ms per launch (host enqueue "
            f"{r['host_ms']:.4f} ms), torch.sparse.mm {r['library_ms']:.4f} "
            f"ms ({'faster' if r['ms'] < r['library_ms'] else 'slower'}: "
            f"{r['library_ms'] / r['ms']:.2f}x), bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']} (share {r['bound_ms'] / r['ms']:.3f}), plain "
            f"{r['plain_ms']:.4f} ms")


def measure_rows(op, L, x, device, lo, hi, label):
    """A row-range entry (K2 on a super-row layout, K3's on a plain one)
    over the units [lo, hi) against the full x, in x's regime: against its
    plain version (x's bar; the max abs error kept), the full launch's
    rows (exactly) and scipy's rows (x's bar, A as the product sees it);
    timed (`device_ms`) beside torch.sparse.mm on the CSR row slice
    against the full x and the bound of the range's work."""
    import torch

    from deepsphere_weather_torch.ops import bcsr

    kind, a, idx, nz = op.forward_layout()
    name, fn, plain, full_fn = (
        (ROW_KERNEL, bcsr.bcsr_super_spmm_rows,
         bcsr.bcsr_super_spmm_rows_reference, bcsr.bcsr_super_spmm)
        if kind == "super" else
        (PLAIN_ROW_KERNEL, bcsr.bcsr_spmm_rows,
         bcsr.bcsr_spmm_rows_reference, bcsr.bcsr_spmm))
    n, m = x.shape
    unit = op.rows // a.shape[0]
    x_pad = torch.nn.functional.pad(x, (0, (-m) % 128, 0, op.rows - n))
    y = fn(a, idx, x_pad, lo, hi, nz=nz)
    want = plain(a, idx, x_pad, lo, hi, nz=nz)
    full = full_fn(a, idx, x_pad, nz)[lo * unit:hi * unit]
    dt = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    e_plain = _rel_err_card(y.float(), want.float())
    e_full = float((y.float() - full.float()).abs().max())
    v0, v1 = lo * unit, min(hi * unit, n)
    mat = L.copy()
    if a.dtype == torch.bfloat16 or dt == "bf16":
        mat.data = torch.from_numpy(L.data).to(torch.bfloat16).float().numpy()
    e_scipy = rel_err(y[:v1 - v0].float().cpu().numpy(),
                      mat[v0:v1] @ x.float().cpu().numpy())
    if not (e_plain < BARS[dt] and e_full == 0 and e_scipy < BARS[dt]):
        raise AssertionError(f"{label} {name} rows [{lo}, {hi}): vs plain "
                             f"{e_plain:.3e}, vs the full launch {e_full:.3e} "
                             f"(must be 0), vs scipy {e_scipy:.3e}")
    a_rng = a[lo:hi]
    nnz, _, x_blocks = _block_counts(
        KERNEL if kind == "super" else PLAIN_KERNEL, a_rng, idx[lo:hi])
    t_bytes, t_ops = (_gather_bound if dt == "fp32" else _bound)(
        a_rng, x, nnz, x_blocks, out_rows=(hi - lo) * unit)
    csr = _csr(L[v0:v1], device, x.dtype)
    args = (a, idx, x_pad, lo, hi)
    return {"kernel": name, "units": [lo, hi],
            "regime": bcsr.spmm_regime(a.dtype, x.dtype, kind == "super"),
            "max_abs_err": float((y.float() - want.float()).abs().max()),
            "rel_err_plain": e_plain, "rel_err_scipy": e_scipy,
            "ms": device_ms(lambda: fn(*args, nz=nz)),
            "host_ms": host_ms(lambda: fn(*args, nz=nz)),
            "plain_ms": device_ms(lambda: plain(*args, nz=nz), n_iter=5),
            "library_ms": device_ms(lambda: torch.sparse.mm(csr, x)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


@clocked
def phase_gather(device, subdivs, width):
    """The gather body's other entries at HEALPix-16 and -64 level 0,
    width 1024 (phase_parity took K1 and K3 with fp32 A): K1 and K3 with
    bf16-stored A against fp32 x (A widened exactly), and the row ranges
    K2 and K3's (rank 0's of 2 node shards: units [0, n/2)) with fp32 A,
    each against its plain version, scipy and, for the ranges, the full
    launch's rows; timed beside torch.sparse.mm and the bound. Returns
    {"bf16_a": {kernel: {shape: reading}}, "rows": {kernel: {shape:
    reading}}}."""
    import torch

    from deepsphere_weather_torch.ops import bcsr

    rng = np.random.default_rng(SEED + 90)
    out = {"bf16_a": {KERNEL: {}, PLAIN_KERNEL: {}},
           "rows": {ROW_KERNEL: {}, PLAIN_ROW_KERNEL: {}}}
    for subdiv in subdivs:
        L = _laplacian(subdiv)
        n = L.shape[0]
        shape = f"x{n}_{width}"
        x = torch.from_numpy(rng.standard_normal((n, width)).astype(
            np.float32)).to(device)
        L_bf16 = L.copy()
        L_bf16.data = torch.from_numpy(L.data).to(
            torch.bfloat16).float().numpy()
        ref_bf16 = L_bf16 @ x.cpu().numpy()
        for rps in (2, 0):
            op = _parity_op(subdiv, L, torch.bfloat16, rps, device)
            kname = _layout(op)[0]
            label = f"{kname} HEALPix-{subdiv} bf16 A, fp32 x[{n}, {width}]"
            r = measure(op, L, x, device, label)
            err = rel_err(r.pop("y").cpu().numpy(), ref_bf16)
            if not err < BARS["fp32"]:
                raise AssertionError(f"{label}: vs scipy (A rounded to bf16 "
                                     f"as stored) {err:.3e}")
            r.update(regime=bcsr.spmm_regime(torch.bfloat16, torch.float32,
                                             rps > 0), rel_err_scipy=err)
            out["bf16_a"][kname][shape] = r
            log("gather", f"{label} ({r['regime']}): vs plain version rel "
                          f"{r['rel_err_plain']:.3e} max abs "
                          f"{r['max_abs_err']:.3e}, vs scipy {err:.3e} (bar "
                          f"{BARS['fp32']:g}); " + _verdict(r))
            op32 = _parity_op(subdiv, L, torch.float32, rps, device)
            half = max(1, op32.forward_layout()[1].shape[0] // 2)
            label = f"HEALPix-{subdiv} fp32 x[{n}, {width}]"
            r = measure_rows(op32, L, x, device, 0, half, label)
            out["rows"][r["kernel"]][shape] = r
            log("gather", f"{r['kernel']} {label} units [0, {half}) "
                          f"({r['regime']}): vs plain version rel "
                          f"{r['rel_err_plain']:.3e} max abs "
                          f"{r['max_abs_err']:.3e}, equal to the full "
                          f"launch's rows, vs scipy's rows "
                          f"{r['rel_err_scipy']:.3e} (bar {BARS['fp32']:g}); "
                          + _verdict(r))
    return out


@clocked
def phase_mixed(device, subdivs, width):
    """K1's mixed regime, fp32 A against bf16 x (the tensor-core body
    with A rounded to bf16 in registers, as the TPU kernel casts it), at
    HEALPix-16 and -64 level 0, width 1024, whole and its row range (K2,
    units [0, n/2)): against its plain version and scipy with A rounded to
    bf16 (the bf16 bar), the range against the full launch's rows
    (exactly); timed beside torch.sparse.mm (bf16 CSR, bf16 x) and the
    bound. Returns {kernel: {shape: reading}}."""
    import torch

    from deepsphere_weather_torch.ops import bcsr

    rng = np.random.default_rng(SEED + 91)
    out = {KERNEL: {}, ROW_KERNEL: {}}
    for subdiv in subdivs:
        L = _laplacian(subdiv)
        n = L.shape[0]
        shape = f"x{n}_{width}"
        x = torch.from_numpy(rng.standard_normal((n, width)).astype(
            np.float32)).to(device, torch.bfloat16)
        L_bf16 = L.copy()
        L_bf16.data = torch.from_numpy(L.data).to(
            torch.bfloat16).float().numpy()
        op = _parity_op(subdiv, L, torch.float32, 2, device)
        label = f"{KERNEL} HEALPix-{subdiv} fp32 A, bf16 x[{n}, {width}]"
        r = measure(op, L, x, device, label)
        err = rel_err(r.pop("y").float().cpu().numpy(),
                      L_bf16 @ x.float().cpu().numpy())
        if not err < BARS["bf16"]:
            raise AssertionError(f"{label}: vs scipy (A rounded to bf16) "
                                 f"{err:.3e}")
        r.update(regime=bcsr.spmm_regime(torch.float32, torch.bfloat16),
                 rel_err_scipy=err)
        out[KERNEL][shape] = r
        log("mixed", f"{label} ({r['regime']}): vs plain version rel "
                     f"{r['rel_err_plain']:.3e}, vs scipy (A rounded to "
                     f"bf16) {err:.3e} (bar {BARS['bf16']:g}); " + _verdict(r))
        half = max(1, op.svals.shape[0] // 2)
        r = measure_rows(op, L, x, device, 0, half,
                         f"HEALPix-{subdiv} fp32 A, bf16 x[{n}, {width}]")
        out[ROW_KERNEL][shape] = r
        log("mixed", f"{ROW_KERNEL} HEALPix-{subdiv} fp32 A, bf16 x[{n}, "
                     f"{width}] units [0, {half}) ({r['regime']}): vs "
                     f"plain version rel {r['rel_err_plain']:.3e}, equal to "
                     f"the full launch's rows, vs scipy's rows "
                     f"{r['rel_err_scipy']:.3e} (bar {BARS['bf16']:g}); "
                     + _verdict(r))
    _PARITY_OPS.clear()
    return out


@clocked
def phase_parity_regimes(device, subdivs, batch):
    """K3 at the main path's widths (bf16, HEALPix-16) against scipy, and
    both regimes of fp32 A against bf16 x at each of `subdivs` (timed at
    the first: round_a=False is K4's function). Returns the widest error
    vs the plain version and K4's row (`measure` at the first subdiv)."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import BlockSparseOperator

    rng = np.random.default_rng(SEED + 4)
    L = _laplacian(subdivs[0])
    op = BlockSparseOperator.from_scipy(L, dtype=torch.bfloat16,
                                        rows_per_super=0, device=device)
    worst, k4 = 0.0, None
    for w in [batch * f for f in WIDTH_FEATURES]:
        x_np = rng.standard_normal((L.shape[0], w)).astype(np.float32)
        x = torch.from_numpy(x_np).to(device, torch.bfloat16)
        res = measure(op, L, x, device, f"width {w}", timed=False)
        err = rel_err(res["y"].float().cpu().numpy(),
                      L @ x.float().cpu().numpy())
        if not err < BARS["bf16"]:
            raise AssertionError(f"{PLAIN_KERNEL} width {w}: vs scipy "
                                 f"{err:.3e} breaks the {BARS['bf16']:g} bar")
        worst = max(worst, res["max_abs_err"])
        log("parity", f"{PLAIN_KERNEL} HEALPix-{subdivs[0]} bf16 width {w}: "
                      f"rel err vs scipy {err:.3e}, " + _fmt(res))
    # fp32 A against bf16 x: round_a=True (K3's regime) rounds A to bf16,
    # round_a=False (K4's) keeps it fp32; scipy holds each to its own A
    for subdiv in subdivs:
        L = _laplacian(subdiv)
        op32 = BlockSparseOperator.from_scipy(L, dtype=torch.float32,
                                              rows_per_super=0, device=device)
        x = torch.from_numpy(rng.standard_normal(
            (L.shape[0], MATVEC_WIDTH)).astype(np.float32)).to(
                device, torch.bfloat16)
        xs = x.float().cpu().numpy()
        L_bf16 = L.copy()
        L_bf16.data = torch.from_numpy(L.data).to(torch.bfloat16).float().numpy()
        for round_a, L_ref in ((True, L_bf16), (False, L)):
            timed = subdiv == subdivs[0]
            res = measure(op32, L, x, device, f"round_a={round_a}",
                          round_a=round_a, timed=timed)
            err = rel_err(res["y"].float().cpu().numpy(), L_ref @ xs)
            if not err < BARS["bf16"]:
                raise AssertionError(f"{PLAIN_KERNEL} HEALPix-{subdiv} "
                                     f"round_a={round_a}: vs scipy {err:.3e}")
            worst = max(worst, res["max_abs_err"])
            if timed and not round_a:
                k4 = {k: res[k] for k in ("ms", "host_ms", "plain_ms",
                                          "library_ms", "library_dtype",
                                          "bound_ms", "bound_by",
                                          "max_abs_err")}
            log("parity", f"{PLAIN_KERNEL} HEALPix-{subdiv} fp32 A, bf16 "
                          f"x[{L.shape[0]}, {MATVEC_WIDTH}], round_a="
                          f"{round_a}: rel err vs scipy (A "
                          f"{'rounded to bf16' if round_a else 'fp32'}) "
                          f"{err:.3e} (bar {BARS['bf16']:g}), " + _fmt(res))
        split = split_check(L, device, subdiv)
        if subdiv == subdivs[0]:
            k4["split_reading"] = split
    return worst, k4


def split_check(L, device, subdiv):
    """K4's split told apart from K3's rounding, which the bf16 bar cannot
    do: on `split_probe`'s product (tests/torch_split_probe.py) the exact
    output is about 0, so max |y - A x| / max (|A| |x|) reads what the
    regime did to A. round_a=False (hi + lo) must read under SPLIT_BAR and
    round_a=True (hi alone) above it. Returns both readings."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import (BlockSparseOperator,
                                                   bcsr_spmm)
    from torch_split_probe import SPLIT_BAR, split_probe

    A, x_np, reading = split_probe(L, MATVEC_WIDTH, SEED + 5)
    op = BlockSparseOperator.from_scipy(A, dtype=torch.float32,
                                        rows_per_super=0, device=device)
    _, a, idx, nz = _layout(op)
    x = torch.nn.functional.pad(torch.from_numpy(x_np),
                                (0, 0, 0, op.rows - A.shape[0])).to(
                                    device, torch.bfloat16)
    got = {}
    for key, round_a in (("hi_lo", False), ("hi", True)):
        y = bcsr_spmm(a, idx, x, nz, round_a=round_a)
        got[key] = reading(y.float().cpu().numpy())
    log("parity", f"{PLAIN_KERNEL} HEALPix-{subdiv} split probe (fp32 A, "
                  f"bf16 x[{A.shape[0]}, {MATVEC_WIDTH}], A x = 0): max|y - "
                  f"Ax| / max(|A||x|) round_a=False (hi + lo) "
                  f"{got['hi_lo']:.3e}, round_a=True (hi) {got['hi']:.3e}, "
                  f"bar {SPLIT_BAR:.3e} between them")
    if not got["hi_lo"] < SPLIT_BAR < got["hi"]:
        raise AssertionError(
            f"{PLAIN_KERNEL} HEALPix-{subdiv} split probe: hi + lo "
            f"{got['hi_lo']:.3e} and hi {got['hi']:.3e} do not lie on either "
            f"side of {SPLIT_BAR:.3e}")
    return got


@clocked
def phase_parity_backward(device, subdiv, width):
    """d/dx sum((Lx)^2) through the operator's autograd.Function against
    2 L^T (L x): the knn L (symmetric: the backward reuses the forward
    arrays) and D L with a random positive diagonal D (through the
    transposed layout). fp32 x takes the ELL route; K1 and K3 are held on
    their own layouts too, the operator's ELL taken away (their fp32
    regime, the gather body, which no model path reaches)."""
    import copy

    import torch
    from scipy import sparse

    from deepsphere_weather_torch.ops.bcsr import (
        BlockSparseOperator,
        launch_counts,
    )

    L = _laplacian(subdiv)
    rng = np.random.default_rng(SEED + 5)
    D = sparse.diags(rng.uniform(0.5, 2.0, L.shape[0]).astype(np.float32))
    x_np = rng.standard_normal((L.shape[0], width)).astype(np.float32)
    for label, mat, sym in (("knn L", L, True),
                            ("D L", (D @ L).tocsr(), False)):
        m64 = mat.astype(np.float64)
        want = 2.0 * (m64.T @ (m64 @ x_np.astype(np.float64)))
        for rps in (2, 0):
            op = BlockSparseOperator.from_scipy(
                mat, symmetric=sym, rows_per_super=rps, device=device)
            block = copy.copy(op)
            block.ell = None
            routes = [(_layout(op)[0], block)]
            if rps:
                routes.insert(0, (ELL_KERNEL, op))
            for kname, route in routes:
                before = dict(launch_counts)
                x = torch.from_numpy(x_np).to(device).requires_grad_()
                y = route.matvec(x)
                if y.grad_fn is None:
                    raise AssertionError(f"{kname}: L @ x has no grad_fn")
                (y ** 2).sum().backward()
                torch.cuda.synchronize()
                launched = {k: v - before[k] for k, v in launch_counts.items()
                            if v != before[k]}
                if launched != {kname: 2}:
                    raise AssertionError(f"{kname} {label}: launched "
                                         f"{launched} for one forward and one "
                                         "backward")
                layout = (op.ell if kname == ELL_KERNEL
                          else op).transpose_layout()[0]
                err = rel_err(x.grad.cpu().numpy(), want)
                log("parity", f"{kname} backward HEALPix-{subdiv} {label} "
                              f"({'same arrays' if sym else 'transposed ' + layout + ' layout'}"
                              f"), fp32 x[{L.shape[0]}, {width}]: d/dx "
                              f"sum((Lx)^2) vs 2 L^T (L x) {err:.3e} (bar "
                              f"{GRAD_BAR:g})")
                if not err < GRAD_BAR:
                    raise AssertionError(f"{kname} backward {label}: "
                                         f"{err:.3e} breaks the {GRAD_BAR:g} "
                                         "bar")


@clocked
def phase_parity_rows(device, subdivs, width):
    """K2 alone, and the plain layout's row range (fp32, bf16, and fp32 A
    against bf16 x in both regimes): each node shard's row-range launch,
    for 2 and 4 shards, against the rows of the full launch (exactly), its
    plain version (exactly in the fp32-x regimes, else at the bf16 bar)
    and scipy's rows (the bars); then the ELL kernel's row ranges and K5's
    fold over it (`parity_ell_rows`). Returns the ELL row range's times at
    the last of `subdivs`."""
    import torch
    import torch.nn.functional as F

    from deepsphere_weather_torch.ops import BlockSparseOperator, bcsr

    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(SEED + 12)
    # (kernel, A dtype, x dtype, round_a of the plain layout)
    checks = [(ROW_KERNEL, bf16, bf16, None), (ROW_KERNEL, f32, f32, None),
              (PLAIN_ROW_KERNEL, f32, f32, None),
              (PLAIN_ROW_KERNEL, bf16, bf16, None),
              (PLAIN_ROW_KERNEL, f32, bf16, True),
              (PLAIN_ROW_KERNEL, f32, bf16, False)]
    for subdiv in subdivs:
        L = _laplacian(subdiv)
        n = L.shape[0]
        x_np = rng.standard_normal((n, width)).astype(np.float32)
        L_bf16 = L.copy()
        L_bf16.data = torch.from_numpy(L.data).to(bf16).float().numpy()
        for kname, a_dt, x_dt, round_a in checks:
            op = BlockSparseOperator.from_scipy(
                L, dtype=a_dt, rows_per_super=2 if kname == ROW_KERNEL else 0,
                device=device)
            _, a, idx, nz = op.forward_layout()
            x = torch.from_numpy(x_np).to(device, x_dt)
            x_pad = F.pad(x, (0, 0, 0, op.rows - n))
            if kname == ROW_KERNEL:
                full = bcsr.bcsr_super_spmm(a, idx, x_pad, nz)
                rows_fn, plain_fn, kw = (bcsr.bcsr_super_spmm_rows,
                                         bcsr.bcsr_super_spmm_rows_reference,
                                         {"nz": nz})
            else:
                # round_a None: a regime it does not touch
                kw = {"nz": nz, "round_a": round_a is not False}
                full = bcsr.bcsr_spmm(a, idx, x_pad, **kw)
                rows_fn, plain_fn = (bcsr.bcsr_spmm_rows,
                                     bcsr.bcsr_spmm_rows_reference)
            # scipy with A as the product sees it (rounded to bf16 when
            # stored so, or against bf16 x with round_a)
            ref = ((L_bf16 if a_dt == bf16 or round_a else L)
                   @ x.float().cpu().numpy())
            bar = BARS["bf16" if x_dt == bf16 else "fp32"]
            # the bf16-x bodies sum on the tensor cores, in another order
            # than the plain version: held to the bar there, else exact
            exact = x_dt == f32
            label = (f"{kname} HEALPix-{subdiv} {str(a_dt)[6:]} A, "
                     f"{str(x_dt)[6:]} x[{n}, {width}]"
                     + ("" if round_a is None else f", round_a={round_a}"))
            unit = op.rows // a.shape[0]
            worst = {"plain": 0.0, "full": 0.0, "scipy": 0.0}
            for n_node, r in ((2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)):
                # rank r's node range and the units (super-rows or row
                # blocks) that cover it
                v0, v1 = r * n // n_node, (r + 1) * n // n_node
                lo, hi = v0 // unit, -(-v1 // unit)
                y = rows_fn(a, idx, x_pad, lo, hi, **kw)
                want = plain_fn(a, idx, x_pad, lo, hi, **kw)
                e_plain = (float((y.float() - want.float()).abs().max())
                           if exact else rel_err(y.float().cpu(),
                                                 want.float().cpu()))
                e_full = float((y.float() - full[lo * unit:hi * unit]
                                .float()).abs().max())
                e_scipy = rel_err(y[v0 - lo * unit:v1 - lo * unit]
                                  .float().cpu().numpy(), ref[v0:v1])
                if (e_plain if exact else not e_plain < bar) or e_full \
                        or not e_scipy < bar:
                    raise AssertionError(
                        f"{label} rows [{v0}, {v1}): vs plain version "
                        f"{e_plain:.3e} ({'must be 0' if exact else 'bar'}),"
                        f" vs full launch {e_full:.3e} (must be 0), vs scipy "
                        f"{e_scipy:.3e} (bar {bar:g})")
                worst = {k: max(worst[k], e) for k, e in zip(
                    worst, (e_plain, e_full, e_scipy))}
            log("parity", f"{label}, 2 and 4 node shards (units of {unit} "
                          f"rows): vs plain version "
                          f"{'max abs error' if exact else 'rel err'} "
                          f"{worst['plain']:.3e}, max abs error vs the full "
                          f"launch's rows {worst['full']:.3e}; rel err vs "
                          f"scipy's rows {worst['scipy']:.3e} (bar {bar:g})")
        ell_rows = parity_ell_rows(device, L, x_np, subdiv, rng)
    return ell_rows


def parity_ell_rows(device, L, x_np, subdiv, rng):
    """The ELL kernel's row ranges, 2 and 4 node shards, against the full
    launch's rows and the plain version (exactly) and scipy's rows (fp32
    bar), on the knn L and on the transposed layout of D L (D a random
    positive diagonal); K5's fold: 2 members' x in one launch's columns
    (the op's vmap rule, and a row range of the folded columns) against
    one launch per member, exactly; and rank 0's row range of 2 timed
    beside its bound, plain version and cuSPARSE's CSR row slice."""
    import torch
    from scipy import sparse

    from deepsphere_weather_torch.ops import EllOperator, bcsr

    n, width = x_np.shape
    x = torch.from_numpy(x_np).to(device)
    D = sparse.diags(rng.uniform(0.5, 2.0, n).astype(np.float32))
    for label, mat, sym in (("knn L", L, True),
                            ("D L, transposed layout", (D @ L).tocsr(),
                             False)):
        ell = EllOperator.from_scipy(mat, symmetric=sym, device=device)
        _, vals, cols, tables = (ell.forward_layout() if sym
                                 else ell.transpose_layout())
        ref = (mat if sym else mat.T.tocsr()) @ x_np
        full = bcsr.ell_spmm(vals, cols, x, tables)
        worst = 0.0
        for n_node, r in ((2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)):
            v0, v1 = r * n // n_node, (r + 1) * n // n_node
            y = bcsr.ell_spmm_rows(vals, cols, x, v0, v1, tables)
            e_plain = float((y - bcsr.ell_spmm_rows_reference(
                vals, cols, x, v0, v1)).abs().max())
            e_full = float((y - full[v0:v1]).abs().max())
            e_scipy = rel_err(y.cpu().numpy(), ref[v0:v1])
            if e_plain or e_full or not e_scipy < BARS["fp32"]:
                raise AssertionError(
                    f"{ELL_ROW_KERNEL} HEALPix-{subdiv} {label} rows [{v0}, "
                    f"{v1}): vs plain version {e_plain:.3e}, vs full launch "
                    f"{e_full:.3e} (both must be 0), vs scipy {e_scipy:.3e}")
            worst = max(worst, e_scipy)
        log("parity", f"{ELL_ROW_KERNEL} HEALPix-{subdiv} {label}, fp32 "
                      f"x[{n}, {width}], 2 and 4 node shards: equal to the "
                      f"full launch's rows and to the plain version (max abs "
                      f"error 0); rel err vs scipy's rows {worst:.3e} (bar "
                      f"{BARS['fp32']:g})")
    # K5: 2 members folded into the columns of one launch
    xm = torch.from_numpy(rng.standard_normal((2, n, width // 2)).astype(
        np.float32)).to(device)
    before = bcsr.launch_counts[ELL_KERNEL]
    loc, blocks, urows, umax, rmax = ell.tables
    folded = torch.func.vmap(lambda xi: bcsr.spmm_ell(
        ell.vals, ell.cols, loc, blocks, urows, xi, umax, rmax))(xm)
    n_launch = bcsr.launch_counts[ELL_KERNEL] - before
    per = torch.stack([bcsr.ell_spmm(ell.vals, ell.cols, xi, ell.tables)
                       for xi in xm])
    rows = bcsr.ell_spmm_rows(
        ell.vals, ell.cols, xm.movedim(0, 1).reshape(n, width).contiguous(),
        0, n // 2, ell.tables).reshape(n // 2, 2, width // 2).movedim(1, 0)
    if n_launch != 1 or not torch.equal(folded, per) or \
            not torch.equal(rows, per[:, :n // 2]):
        raise AssertionError(f"K5 over {ELL_KERNEL} HEALPix-{subdiv}: "
                             f"{n_launch} launches for 2 members; folded "
                             "product or row range differs from the "
                             "per-member launches")
    log("parity", f"K5 over {ELL_KERNEL} HEALPix-{subdiv}: 2 members x[{n}, "
                  f"{width // 2}] folded into one launch (the op's vmap "
                  f"rule) and into one row range [0, {n // 2}): equal to "
                  f"one launch per member (max abs error 0)")
    # rank 0's row range of 2 (its shard's rows and union tables), timed
    v1 = n // 2
    _, vals, cols, tables, _, _ = ell.row_shard(0, v1, None).forward_layout()
    csr = _csr(L[:v1], device, torch.float32)
    t_bytes, t_ops = _ell_bound(vals, cols, x, out_rows=v1)
    res = {"ms": device_ms(lambda: bcsr.ell_spmm_rows(vals, cols, x, 0, v1,
                                                      tables)),
           "host_ms": host_ms(lambda: bcsr.ell_spmm_rows(vals, cols, x, 0,
                                                         v1, tables)),
           "plain_ms": device_ms(lambda: bcsr.ell_spmm_rows_reference(
               vals, cols, x, 0, v1), n_iter=5),
           "library_ms": device_ms(lambda: torch.sparse.mm(csr, x)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "shape": f"rows [0, {v1}) of x[{n}, {width}]"}
    log("times", f"{ELL_ROW_KERNEL} HEALPix-{subdiv} fp32 {res['shape']}: "
                 f"{res['ms']:.4f} ms (host enqueue {res['host_ms']:.4f} ms, "
                 f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}, plain "
                 f"{res['plain_ms']:.4f} ms, cuSPARSE row slice "
                 f"{res['library_ms']:.4f} ms)")
    return res


# ---------------------------------------------------------------------------
# The forecast service (serving main path)
# ---------------------------------------------------------------------------

def tensor_info(n_node):
    n_in = F_STATIC + F_BC + F_DYN
    return {"input_n_feature": n_in, "output_n_feature": F_DYN,
            "input_n_time": len(INPUT_K), "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": n_node}},
            "output_shape_info": {"dynamic": {"node": n_node}}}


def build_flagship(device, subdiv, params=None, geometry=None,
                   precision="bfloat16", dense_threshold=None,
                   batch_norm=False):
    from deepsphere_weather_torch.models import UNetSpherical

    model = UNetSpherical(
        tensor_info(12 * subdiv ** 2), "healpix",
        {"subdivisions": subdiv, "nest": True}, knn=KNN, pool_method="max",
        increment_learning=True, numeric_precision=precision,
        dense_threshold=dense_threshold, geometry=geometry, device=device,
        batch_norm=batch_norm)
    if params is not None:
        model.load_state_dict(params)
    return model.eval()


def forward_vs_cpu(device, subdiv, params, x, nz=None):
    """The flagship's bf16 forward of x on the card and on the CPU plain
    path. A ReLU or max-pool decision that one bf16 rounding flips changes
    its output by O(1) (the seeded network amplifies it), so the CPU takes
    the card's decisions (`steer`). Returns the relative error of the
    network's output minus x_last (`err`; `err_own` with the CPU's own
    decisions), how far each decision that differed sat from its kink or
    tie (`gaps`) and the count of decisions. `nz` replaces the slot list
    of the card's level-0 operator (a planted fault, for
    scripts/torch_chip_readings.py)."""
    import torch
    from torch_steer import steer

    with torch.inference_mode():
        card_model = build_flagship(device, subdiv, params)
        if nz is not None:
            card_model.geometry.cheb_ops[0].bcsr.nz = nz
        decisions, _ = steer(card_model)
        y = card_model(x.to(device)).cpu()
        cpu_model = build_flagship(torch.device("cpu"), subdiv, params)
        y_own = cpu_model(x)
        _, gaps = steer(cpu_model, decisions)
        y_cpu = cpu_model(x)
    x_last = x[:, -1:, :, -F_DYN:]
    return {"err": rel_err((y - x_last).numpy(), (y_cpu - x_last).numpy()),
            "err_own": rel_err((y - x_last).numpy(),
                               (y_own - x_last).numpy()),
            # a ReLU decides per element, a max pool per window
            "gaps": gaps, "decisions": sum(
                d.numel() // (d.shape[2] if d.dim() == 4 else 1)
                for d in decisions)}


def count_forwards(rollout):
    """Make `rollout.call` count the model forwards it runs (block_size
    per call) into the returned one-element list."""
    forwards, call = [0], rollout.call

    def counted(*args):
        forwards[0] += rollout.meta["block_size"]
        return call(*args)
    rollout.call = counted
    return forwards


def synthetic_service(model, params, batch, n_steps, rng, block=BLOCK):
    """`model` (with `params` loaded when given) exported behind
    ForecastService (batch `batch`, block `block`), with scalers fitted to
    synthetic physical-unit inputs drawn from `rng`, and a history and
    boundary conditions of `batch` samples for `n_steps` steps. Returns
    (service, rollout, history, bc, scaler)."""
    from deepsphere_weather_torch.data.scalers import GlobalStandardScaler
    from deepsphere_weather_torch.serve import ForecastService, export_rollout

    V = model.input_n_node
    H = 1 - min(INPUT_K)

    def history(n):             # z500 (~5400 m) and t850 (~270 K) scales
        return (rng.standard_normal((n, H, V, F_DYN)) * [300.0, 10.0]
                + [5400.0, 270.0]).astype(np.float32)

    def boundary(n, steps):     # TOA solar radiation scale
        return (rng.standard_normal((n, steps, len(INPUT_K), V, F_BC)) * 100.0
                + 300.0).astype(np.float32)

    static = rng.standard_normal((V, F_STATIC)).astype(np.float32)
    scaler = GlobalStandardScaler().fit(history(8).reshape(-1, V, F_DYN))
    scaler_bc = GlobalStandardScaler().fit(boundary(2, 4).reshape(-1, V, F_BC))
    rollout = export_rollout(
        model, params, input_k=INPUT_K, output_k=[0], forecast_cycle=1,
        batch_size=batch, block_size=block, static=static, n_bc_features=F_BC,
        timestep_hours=6.0)
    svc = ForecastService(rollout, scaler=scaler, scaler_bc=scaler_bc)
    return svc, rollout, history(batch), boundary(batch, n_steps), scaler


@clocked
def phase_slice(device, subdiv, batch, n_steps):
    """Drive the forecast service; returns the main-path figures."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.weights import params_from_jax, seeded_params

    t0 = time.perf_counter()
    model = build_flagship(device, subdiv)
    V = model.input_n_node
    params = params_from_jax(seeded_params(model, SEED))
    ops = model.geometry.cheb_ops
    if ops[0].bcsr is None or ops[0].bcsr.svals.dtype != torch.bfloat16:
        raise AssertionError("level 0 must run the bf16 block-sparse operator")
    log("slice", f"UNetSpherical HEALPix-{subdiv} levels "
                 f"{model.geometry.n_nodes} (level 0 block-sparse bf16), "
                 f"built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED + 1)
    svc, rollout, hist, bc, scaler = synthetic_service(model, params, batch,
                                                       n_steps, rng)
    # the exported program runs the model's graph, not its module: count
    # the forwards by the blocks called
    forwards = count_forwards(rollout)

    svc.predict(hist, n_steps=BLOCK, bc=bc[:, :BLOCK])          # warm-up

    # the main path: counts from 0, then a forecast and concurrent requests
    reset_launch_counts()
    forwards[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = svc.predict(hist, n_steps=n_steps, bc=bc)
    torch.cuda.synchronize()
    t_predict = time.perf_counter() - t0
    # request i: history i and its first block of boundary conditions
    t0 = time.perf_counter()
    futs = [None] * N_SUBMIT
    threads = [threading.Thread(target=lambda i=i: futs.__setitem__(
        i, svc.submit(hist[i], n_steps=BLOCK, bc=bc[i, :BLOCK])))
        for i in range(N_SUBMIT)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if None in futs:
        raise AssertionError("not every submit() returned a future")
    answers = [f.result(timeout=600) for f in futs]
    t_submit = time.perf_counter() - t0
    launches = dict(launch_counts)
    n_fwd = forwards[0]
    svc.close()

    if out.shape != (batch, n_steps, 1, V, F_DYN) or not np.isfinite(out).all():
        raise AssertionError(f"forecast {out.shape} is not finite of shape "
                             f"{(batch, n_steps, 1, V, F_DYN)}")
    for a in answers:
        if a.shape != (BLOCK, 1, V, F_DYN) or not np.isfinite(a).all():
            raise AssertionError(f"submit answer {a.shape} is malformed")
    # request i answers what predict gave history i for its first block
    # (other batch padding, so cuBLAS may sum in another order)
    for i, a in enumerate(answers):
        e = rel_err(scaler.transform(a), scaler.transform(out[i, :BLOCK]))
        if not e <= SLICE_TOL:
            raise AssertionError(f"submit answer {i} differs from predict: "
                                 f"{e:.3e} > {SLICE_TOL}")
    if (launches[KERNEL] != LAUNCHES_PER_FORWARD * n_fwd or n_fwd == 0
            or launches[PLAIN_KERNEL]):
        raise AssertionError(f"{launches} kernel launches for {n_fwd} "
                             f"forwards; want {LAUNCHES_PER_FORWARD} {KERNEL}"
                             " each and nothing else")
    log("slice", f"predict {batch} x {n_steps} steps -> {out.shape}, "
                 f"{N_SUBMIT} submits -> {[a.shape for a in answers]}; "
                 f"finite; {n_fwd} forwards, {launches[KERNEL]} {KERNEL} "
                 "launches")

    x = torch.from_numpy(rng.standard_normal(
        (batch, len(INPUT_K), V, F_STATIC + F_BC + F_DYN)).astype(np.float32))
    r = forward_vs_cpu(device, subdiv, params, x)
    gap = max(r["gaps"], default=0.0)
    if not (r["err"] <= SLICE_TOL and gap <= GAP_TOL):
        raise AssertionError(f"card vs CPU forward {r['err']:.3e} (tol "
                             f"{SLICE_TOL}), worst differing decision "
                             f"{gap:.3e} from its kink or tie (tol {GAP_TOL})")
    log("slice", f"card vs CPU plain-path forward (network output minus "
                 f"x_last), the CPU taking the card's ReLU and max-pool "
                 f"decisions: rel err {r['err']:.3e} (tol {SLICE_TOL}); "
                 f"{len(r['gaps'])} of {r['decisions']} decisions differed "
                 f"from the CPU's own, the worst {gap:.3e} from its kink or "
                 f"tie (tol {GAP_TOL}); with the CPU's own decisions "
                 f"{r['err_own']:.3e}")

    xd = x.to(device)
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(xd), n_iter=10)
    return {"launches": launches[KERNEL], "forwards": n_fwd,
            "step_ms": 1e3 * t_predict / n_steps,
            "submit_ms": 1e3 * t_submit, "forward_ms": forward_ms,
            "model": model}


# ---------------------------------------------------------------------------
# The training step (training main path)
# ---------------------------------------------------------------------------

def train_params(model, seed):
    """Seeded weights in the JAX layout, ReZero weights scaled down."""
    from deepsphere_weather_torch.weights import params_from_jax, seeded_params

    tree = seeded_params(model, seed)
    for block in tree.values():
        if isinstance(block, dict) and "rezero_weight" in block:
            block["rezero_weight"] *= TRAIN_REZERO_SCALE
    return params_from_jax(tree)


def train_batch(indexer, n_node, batch, device, seed):
    import torch

    rng = np.random.default_rng(seed)
    W = indexer.window_size
    arrs = {"dynamic": rng.standard_normal((batch, W, n_node, F_DYN)),
            "bc": rng.standard_normal((batch, W, n_node, F_BC)),
            "static": rng.standard_normal((n_node, F_STATIC))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in arrs.items()}


def train_setup(model, ar_iters):
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine import AreaWeights

    indexer = ARIndexer.build(list(INPUT_K), [0], 1, ar_iters)
    area_w = AreaWeights(model.geometry.samplings[0],
                         device=next(model.parameters()).device)
    return indexer, area_w, np.ones(ar_iters + 1, np.float32)


def grads_of(model):
    return {k: p.grad.double().cpu() for k, p in model.named_parameters()}


def grads_close(grads, ref, sums, tol, what="card vs CPU"):
    """Every parameter gradient against the reference's, per key: max abs
    error over max abs of the reference's. A one-element gradient (a
    ReZero weight, the increment scale) is one sum over a block's output
    whose terms cancel: it is held against the sum of its terms'
    magnitudes (`sums`, from `term_sums` on the reference model); any
    other key in `sums` against the scale given there. Returns (worst
    error, key)."""
    worst = (0.0, "")
    for k, g in grads.items():
        r = ref[k].double()
        if r.numel() == 1 and k not in sums:
            raise AssertionError(f"{k}: one element, but no sum of terms")
        scale = sums[k] if k in sums else float(r.abs().max())
        e = float((g.double().cpu() - r).abs().max()) / scale
        worst = max(worst, (e, k))
        if not e <= tol:
            raise AssertionError(f"{k}: {what} {e:.3e} > {tol}")
    return worst


@clocked
def phase_train_check(device, subdiv, batch):
    """(1) The first step's losses and gradients, card vs CPU plain path."""
    import torch

    from deepsphere_weather_torch.engine import make_ar_loss_fn
    from torch_grad_terms import term_sums

    out = []
    params = None
    for dev in (device, torch.device("cpu")):
        model = build_flagship(dev, subdiv).train()
        params = train_params(model, SEED + 6) if params is None else params
        model.load_state_dict(params)
        sums = term_sums(model)
        indexer, area_w, w = train_setup(model, TRAIN_AR)
        data = train_batch(indexer, model.input_n_node, batch, dev, SEED + 7)
        total, per_iter = make_ar_loss_fn(model, indexer, TRAIN_AR + 1)(
            data, w, area_w)
        total.backward()
        out.append((model, total.item(), per_iter.detach().cpu().numpy(),
                    sums))
    (model, total, per_iter, _), (cpu_model, total_c, per_iter_c, sums) = out
    e_total = rel_err(total, total_c)
    e_iter = rel_err(per_iter, per_iter_c)
    e_grad, worst_key = grads_close(grads_of(model), grads_of(cpu_model),
                                    sums, SLICE_TOL)
    log("train", f"(1) HEALPix-{subdiv} AR{TRAIN_AR} batch {batch}: loss "
                 f"{total:.6g} (CPU {total_c:.6g}), rel err {e_total:.3e}; "
                 f"per-iteration losses {np.round(per_iter, 5).tolist()} rel "
                 f"err {e_iter:.3e}; gradients: worst {e_grad:.3e} "
                 f"({worst_key}); tol {SLICE_TOL}")
    for e, what in ((e_total, "total loss"), (e_iter, "per-iteration losses")):
        if not e <= SLICE_TOL:
            raise AssertionError(f"card vs CPU {what}: {e:.3e} > {SLICE_TOL}")


def split_launches(model, n_calls):
    """(run, hook): run(fn) calls fn() and returns (its output, (forward,
    backward)): the launches by kernel it made, its forward ending as
    `model`'s n_calls-th call returns, the end of a train step's forward
    pass (a remat step's recompute calls the model again in the backward;
    the forward hook fires under functional_call too). After
    hook.remove(), (output, None)."""
    from deepsphere_weather_torch.ops.bcsr import launch_counts

    at_call = []
    hook = model.register_forward_hook(
        lambda *_: at_call.append(dict(launch_counts)))

    def run(fn):
        before = dict(launch_counts)
        at_call.clear()
        out = fn()
        if not at_call:
            return out, None
        end = at_call[n_calls - 1]
        return out, ({k: end[k] - before[k] for k in before},
                     {k: launch_counts[k] - end[k] for k in before})
    return run, hook


def run_train(model, ar_iters, batch, n_steps, label, clip=None,
              phase="train", lr=LR, indexer=None, data=None, strategy="RNN",
              remat=False, decreasing=True, memory=False):
    """The training main path: n_steps of make_train_step on one fixed
    batch, counts from 0, the port's Adam at `lr` (clipping the global
    gradient norm at `clip` when given). The batch is `data`, else one
    from SEED + 8; the indexer `indexer`, else `train_setup`'s. Losses
    must be finite, and with `decreasing` fall. Returns losses,
    per-iteration losses, per-step launches (the forward ending at the
    step's ar_iters + 1-th model call, the end of its forward pass: a
    remat step's recompute calls the model again in the backward) and ms (host clock to torch.cuda.synchronize()),
    the first step's (clipped) gradients and, with `memory`, the peak of
    the first step and the last step's own peak past its start
    (allocator readings)."""
    import torch

    from deepsphere_weather_torch.engine import Adam, make_train_step
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    default_indexer, area_w, w = train_setup(model, ar_iters)
    indexer = indexer or default_indexer
    if data is None:
        data = train_batch(indexer, model.input_n_node, batch,
                           next(model.parameters()).device, SEED + 8)
    opt = Adam(model.parameters(), lr=lr, eps=ADAM_EPS,
               gradient_clipping=clip)
    step = make_train_step(model, indexer, opt, ar_iters + 1,
                           ar_training_strategy=strategy, remat=remat)
    run, hook = split_launches(model, ar_iters + 1)
    torch.cuda.synchronize()
    if memory:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = {"losses": [], "per_iter": [], "per_step": [], "ms": []}
    t0 = time.perf_counter()
    for i in range(n_steps):
        if memory and i == n_steps - 1:
            # no torch.cuda.empty_cache() here: the step after it maps its
            # memory again (expandable segments, which the port asks for),
            # which no trainer step does; the own peak counts allocated
            # bytes, which the cache does not change
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t_step = time.perf_counter()
        (total, per_iter), split = run(lambda: step(data, w, area_w))
        torch.cuda.synchronize()
        res["ms"].append(1e3 * (time.perf_counter() - t_step))
        res["losses"].append(total)
        res["per_iter"].append(per_iter)
        res["per_step"].append(split)
        if i == 0:
            res["grads"] = grads_of(model)
            if memory:
                res["first_peak_gib"] = \
                    torch.cuda.max_memory_allocated() / 2 ** 30
    seconds = time.perf_counter() - t0
    if memory:
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["step_gib"] = res["peak_gib"] - base / 2 ** 30
    res["launches"] = dict(launch_counts)
    hook.remove()
    losses = res["losses"] = torch.stack(res["losses"]).cpu().numpy()
    res["per_iter"] = torch.stack(res["per_iter"]).cpu().numpy()
    if not (np.isfinite(losses).all() and np.isfinite(res["per_iter"]).all()
            and (losses[-1] < losses[0] or not decreasing)):
        raise AssertionError(f"{label}: losses {res['per_iter']} are not "
                             "finite" + " and decreasing" * decreasing)
    log(phase, f"{label}: {n_steps} steps, losses {losses[0]:.6g} -> "
               f"{losses[-1]:.6g}, {seconds:.2f} s with the first step; "
               f"launches {res['launches']}")
    res["step"] = lambda: step(data, w, area_w)
    return res


def check_launches(res, kernel, per_forward, n_calls, label, phase="train",
                   remat=False):
    """Every step launched exactly per_forward * n_calls forward and that
    minus NO_GRAD_PRODUCTS backward products on `kernel` (with `remat`
    the recompute's forward products in the backward too), no other
    kernel; returns (forward, backward) launch totals."""
    want_f = per_forward * n_calls
    want_b = want_f * (1 + remat) - NO_GRAD_PRODUCTS
    for i, (fwd, bwd) in enumerate(res["per_step"]):
        if (fwd[kernel], bwd[kernel]) != (want_f, want_b) or \
                sum(fwd.values()) != want_f or sum(bwd.values()) != want_b:
            raise AssertionError(
                f"{label} step {i}: forward {fwd}, backward {bwd}; want "
                f"{want_f} forward and {want_b} backward {kernel} launches")
    n = len(res["per_step"])
    log(phase, f"{label}: {want_f} forward + {want_b} backward {kernel} "
               f"launches in each of {n} steps, no other kernel")
    return want_f * n, want_b * n


def time_steps(steps, batch, card_line, windows=None, n_steps=None):
    """ms per train step of each of `steps` ({label: step}): windows of
    `n_steps` (TIME_STEPS) chained steps on the host clock, ended by
    torch.cuda.synchronize(), taken in turns (A B B A ...) so that drift
    on the card or its host falls on every label alike; best of
    `windows` (TIME_WINDOWS) windows each."""
    import torch

    windows = windows or TIME_WINDOWS
    n_steps = n_steps or TIME_STEPS
    labels = list(steps)
    best = dict.fromkeys(labels, float("inf"))
    for w in range(windows):
        for label in (labels if w % 2 == 0 else labels[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                steps[label]()
            torch.cuda.synchronize()
            best[label] = min(best[label],
                              (time.perf_counter() - t0) / n_steps)
    for label in labels:
        log("times", f"{label}: {1e3 * best[label]:.2f} ms per train step, "
                     f"{batch / best[label]:.2f} samples/s (best of "
                     f"{windows} windows of {n_steps} steps, taken "
                     f"in turns; {card_line})")
    return {label: 1e3 * t for label, t in best.items()}


@clocked
def phase_train(device, subdiv, card_line):
    """(2) the super-row level-0 operator (K1) and (3) the plain one
    (K3), batch 16, 10 steps each at the same weights."""
    import torch

    from deepsphere_weather_torch.ops import BlockSparseOperator, ChebOperator

    model = build_flagship(device, subdiv).train()
    params = train_params(model, SEED + 9)
    model.load_state_dict(params)
    n_calls = TRAIN_AR + 1
    res2 = run_train(model, TRAIN_AR, BATCH, TRAIN_STEPS,
                     f"(2) HEALPix-{subdiv} AR{TRAIN_AR} batch {BATCH} K1")
    f2 = check_launches(res2, KERNEL, LAUNCHES_PER_FORWARD, n_calls, "(2)")

    geom = model.geometry
    op0 = ChebOperator(bcsr=BlockSparseOperator.from_scipy(
        _laplacian(subdiv), dtype=torch.bfloat16, rows_per_super=0,
        device=device))
    model3 = build_flagship(device, subdiv, params, geometry=dataclasses.replace(
        geom, cheb_ops=[op0] + list(geom.cheb_ops[1:]))).train()
    res3 = run_train(model3, TRAIN_AR, BATCH, TRAIN_STEPS,
                     f"(3) HEALPix-{subdiv} AR{TRAIN_AR} batch {BATCH} K3")
    f3 = check_launches(res3, PLAIN_KERNEL, LAUNCHES_PER_FORWARD, n_calls,
                        "(3)")
    e = rel_err(res3["losses"][0], res2["losses"][0])
    log("train", f"(3) vs (2) first-step loss: {res3['losses'][0]:.6g} vs "
                 f"{res2['losses'][0]:.6g}, rel err {e:.3e} (tol {SLICE_TOL})")
    if not e <= SLICE_TOL:
        raise AssertionError(f"(3) vs (2) first-step loss {e:.3e}")
    ms = time_steps({"(2) K1": res2["step"], "(3) K3": res3["step"]}, BATCH,
                    card_line, SMOKE_WINDOWS, SMOKE_STEPS)
    return {"model": model, "steps": {"K1": res2["step"], "K3": res3["step"]},
            "per_iter": res2["per_iter"], "launches": {
        KERNEL: f2, PLAIN_KERNEL: f3}, "ms": {"train16": ms["(2) K1"],
                                              "train16_plain": ms["(3) K3"]}}


@clocked
def phase_train64(device, subdiv, card_line):
    import torch

    t0 = time.perf_counter()
    model = build_flagship(device, subdiv).train()
    if any(op.bcsr is None for op in model.geometry.cheb_ops):
        raise AssertionError("every HEALPix-64 level must be block-sparse")
    model.load_state_dict(train_params(model, SEED + 10))
    log("train64", f"UNetSpherical HEALPix-{subdiv} levels "
                   f"{model.geometry.n_nodes} (all block-sparse bf16), built "
                   f"in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    res = run_train(model, HP64_AR, HP64_BATCH, HP64_STEPS,
                    f"HEALPix-{subdiv} AR{HP64_AR} batch {HP64_BATCH} K1")
    launches = check_launches(res, KERNEL, sum(PRODUCTS_PER_LEVEL),
                              HP64_AR + 1, "train64")
    label = f"HEALPix-{subdiv} AR{HP64_AR} batch {HP64_BATCH}"
    ms = time_steps({label: res["step"]}, HP64_BATCH, card_line,
                    SMOKE_WINDOWS, SMOKE_STEPS)[label]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train64", f"peak device memory {peak:.2f} GiB "
                   "(torch.cuda.max_memory_allocated)")
    products = check_step_products(model, res["step"], subdiv)
    return {"launches": launches, "ms": ms, "peak_gib": peak,
            "per_iter": res["per_iter"], "step": res["step"],
            "products": products}


def step_products(step):
    """Run one train step and record its block-sparse products: the
    (operator, width, dtype) of each `matvec`, and the (A blocks, padded
    width, dtype) of each kernel launch, forward and backward. A launch
    without its slot list (one that would skip no zero block) raises."""
    from deepsphere_weather_torch.ops import bcsr

    matvecs, launches = {}, set()
    matvec, kernel = bcsr.BlockSparseOperator.matvec, bcsr.bcsr_super_spmm

    def record_matvec(op, x):
        matvecs.setdefault((id(op), x.shape[1], x.dtype), op)
        return matvec(op, x)

    def record_launch(a, idx, x, nz=None):
        if nz is None:
            raise AssertionError("a K1 launch of the step had no slot list")
        launches.add((a.data_ptr(), x.shape[1], x.dtype))
        return kernel(a, idx, x, nz)

    bcsr.BlockSparseOperator.matvec = record_matvec
    bcsr.bcsr_super_spmm = record_launch
    try:
        step()
    finally:
        bcsr.BlockSparseOperator.matvec = matvec
        bcsr.bcsr_super_spmm = kernel
    return matvecs, launches


def check_step_products(model, step, subdiv, laplacian=None,
                        phase="train64", name=None):
    """Every level's K1 at each width one train step gives it, forward
    and backward: against its plain version on the same input (bf16 bar)
    and against scipy with that level's Laplacian (`laplacian(level)`,
    HEALPix-`subdiv`'s knn one by default); and every shape the step
    launched K1 at is one of those checked. Returns the (level, width,
    dtype, operator) of each product."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import _fit_rows, _layout_rows

    if laplacian is None:
        def laplacian(level):
            return _laplacian(subdiv >> level)
    name = name or f"HEALPix-{subdiv}"
    matvecs, launched = step_products(step)
    ops = [c.bcsr for c in model.geometry.cheb_ops]
    device = next(model.parameters()).device
    rng = np.random.default_rng(SEED + 11)
    checked, worst = set(), {"plain": 0.0, "scipy": 0.0}
    products = sorted((next(i for i, o in enumerate(ops) if o is op), width,
                       dt, op) for (_, width, dt), op in matvecs.items())
    for level, width, dt, op in products:
        L = laplacian(level)
        n, bar = L.shape[0], BARS["bf16" if dt == torch.bfloat16 else "fp32"]
        x = torch.from_numpy(rng.standard_normal((n, width)).astype(
            np.float32)).to(device, dt)
        g = torch.randn_like(x)
        label = f"{name} level {level} width {width}"
        # forward: the kernel vs its plain version (raises), then vs scipy
        fwd = measure(op, L, x, device, label, timed=False)
        e_fwd = rel_err(fwd["y"].float().cpu(), L @ x.float().cpu().numpy())
        # backward: x.grad of <L x, g> through the operator's
        # autograd.Function, vs the plain version on the transposed
        # layout and vs scipy L^T g
        xg = x.clone().requires_grad_()
        op.matvec(xg).backward(g)
        layout_t = op.transpose_layout()
        kind, a_t, idx_t, nz_t = layout_t
        plain = _kernel_fns(KERNEL if kind == "super" else PLAIN_KERNEL)[1]
        g_pad = torch.nn.functional.pad(g, (0, (-width) % 128, 0, op.rows - n))
        want = plain(a_t, idx_t, _fit_rows(
            g_pad, _layout_rows(layout_t)).contiguous(),
            *(() if nz_t is None else (nz_t,)))[:n, :width]
        e_bwd_plain = rel_err(xg.grad.float().cpu(), want.float().cpu())
        e_bwd = rel_err(xg.grad.float().cpu(),
                        L.T @ g.float().cpu().numpy())
        log(phase, f"K1 {label} {str(dt)[6:]}: forward vs plain version "
                   f"{fwd['rel_err_plain']:.3e}, vs scipy {e_fwd:.3e}; "
                   f"backward vs plain version {e_bwd_plain:.3e}, vs "
                   f"scipy L^T g {e_bwd:.3e} (bar {bar:g})")
        for e, what in ((e_fwd, "forward vs scipy"),
                        (e_bwd_plain, "backward vs plain version"),
                        (e_bwd, "backward vs scipy")):
            if not e < bar:
                raise AssertionError(f"K1 {label}: {what} {e:.3e} breaks "
                                     f"the {bar:g} bar")
        worst["plain"] = max(worst["plain"], fwd["rel_err_plain"],
                             e_bwd_plain)
        worst["scipy"] = max(worst["scipy"], e_fwd, e_bwd)
        a = op.forward_layout()[1]
        checked.add((a.data_ptr(), width + (-width) % 128, dt))
        checked.add((a_t.data_ptr(), width + (-width) % 128, dt))
    if not launched <= checked:
        raise AssertionError(f"the step launched K1 at shapes no check "
                             f"covered: {sorted(launched - checked)}")
    log(phase, f"{len(matvecs)} (level, width) products of the step, "
               f"forward and backward: worst vs plain version "
               f"{worst['plain']:.3e}, vs scipy {worst['scipy']:.3e}; "
               f"they cover all {len(launched)} launch shapes")
    return products


def time_step_products(products, subdiv, device, card_line):
    """The layouts side by side at each (level, width) shape of a train
    step's products (`check_step_products`): K1 on the step's super-row
    operator and K3 on the plain layout of the same level's Laplacian, per
    launch, beside the bound and cuSPARSE. K3 is held to its plain version
    (in `measure`) and to scipy (bf16 bar); the plain versions go untimed.
    Returns (K1 rows, K3 rows)."""
    import torch

    from deepsphere_weather_torch.ops import BlockSparseOperator

    rng = np.random.default_rng(SEED + 15)
    rows = {KERNEL: [], PLAIN_KERNEL: []}
    plain_ops = {}
    for level, width, dt, op in products:
        L = _laplacian(subdiv >> level)
        x = torch.from_numpy(rng.standard_normal((L.shape[0], width)).astype(
            np.float32)).to(device, dt)
        if level not in plain_ops:
            plain_ops[level] = BlockSparseOperator.from_scipy(
                L, dtype=dt, rows_per_super=0, device=device)
        for name, layout_op in ((KERNEL, op), (PLAIN_KERNEL, plain_ops[level])):
            label = f"{name} HEALPix-{subdiv} level {level} width {width}"
            r = measure(layout_op, L, x, device, label, plain_timed=False)
            line = (f"{name} HEALPix-{subdiv} level {level} {str(dt)[6:]} "
                    f"x[{L.shape[0]}, {width}]: {r['ms']:.4f} ms (bound "
                    f"{r['bound_ms']:.4f} ms by {r['bound_by']}, cuSPARSE "
                    f"{r['library_ms']:.4f} ms), blocks {r['blocks_nonzero']}")
            if name == PLAIN_KERNEL:
                bar = BARS["bf16" if dt == torch.bfloat16 else "fp32"]
                e = rel_err(r["y"].float().cpu(), L @ x.float().cpu().numpy())
                if not e < bar:
                    raise AssertionError(f"{label}: vs scipy {e:.3e} breaks "
                                         f"the {bar:g} bar")
                k1_ms = rows[KERNEL][-1]["ms"]
                line += (f", vs plain version {r['rel_err_plain']:.3e}, vs "
                         f"scipy {e:.3e} (bar {bar:g}); K3 / K1 "
                         f"{r['ms'] / k1_ms:.3f}")
            log("times", f"{line} ({card_line})")
            rows[name].append({"level": level, "width": width, "ms": r["ms"],
                               "bound_ms": r["bound_ms"],
                               "library_ms": r["library_ms"]})
    k1, k3 = (sum(r["ms"] for r in rows[k]) for k in (KERNEL, PLAIN_KERNEL))
    log("times", f"layouts over the HEALPix-{subdiv} step's {len(products)} "
                 f"shapes, one launch each: K1 (super-row) {k1:.4f} ms, K3 "
                 f"(plain) {k3:.4f} ms, K3 / K1 {k3 / k1:.3f} ({card_line})")
    return rows[KERNEL], rows[PLAIN_KERNEL]


@clocked
def phase_train64f32(device, card_line):
    """train64f32: the shipped fp32 HEALPix-64 configuration (F32_CONFIG)
    through `models.get_model`, at its own float32, full width and depth:
    levels 0 and 1 block-sparse, whose every product is the ELL kernel's
    (fp32 x), level 2 dense. 3 steps at train64's traffic (AR2, batch 8,
    RNN, area-weighted MSE, Adam eps 1e-7 with the config's clipping):
    exactly 18 + 16 ELL launches a model call and nothing else, peak
    memory, the step time; one untimed step on K1's fp32 regime (the
    gather body; the ELL taken away) launching K1 alone; a forecast call (no grad) at batch 8; each
    (level, width) shape of the step (`ell_step_shapes`); one batch-1 AR1
    step card vs CPU at GRAD_BAR."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import launch_counts

    t0 = time.perf_counter()
    cfg = _grids_config(F32_CONFIG)
    precision = cfg["training_settings"]["numeric_precision"]
    model = grids_model(device, cfg, precision).train()
    geom = model.geometry
    kinds = ["dense" if o.dense is not None else
             "ell" if o.bcsr is not None and o.bcsr.ell is not None else "?"
             for o in geom.cheb_ops]
    if precision != "float32" or kinds != ["ell", "ell", "dense"]:
        raise AssertionError(f"{F32_CONFIG}: {precision}, levels {kinds}")
    params = train_params(model, SEED + 40)
    model.load_state_dict(params)
    log("train64f32", f"{F32_CONFIG}: UNetSpherical levels {geom.n_nodes} "
                      f"({', '.join(kinds)}), {precision}, built in "
                      f"{time.perf_counter() - t0:.1f} s")
    per_forward = sum(PRODUCTS_PER_LEVEL[:2])
    label = f"{F32_CONFIG} fp32 AR{HP64_AR} batch {HP64_BATCH}"
    torch.cuda.reset_peak_memory_stats()
    res = run_train(model, HP64_AR, HP64_BATCH, HP64_STEPS, label,
                    clip=cfg["training_settings"]["gradient_clipping"],
                    phase="train64f32")
    launches = check_launches(res, ELL_KERNEL, per_forward, HP64_AR + 1,
                              label, phase="train64f32")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # one step on K1's fp32 regime, the operators' ELL taken away (the
    # gather body, the block layout's own fp32 route): its launches, untimed
    sparse = [o.bcsr for o in geom.cheb_ops if o.bcsr is not None]
    ells = [o.ell for o in sparse]
    before = dict(launch_counts)
    for o in sparse:
        o.ell = None
    try:
        res["step"]()
    finally:
        for o, e in zip(sparse, ells):
            o.ell = e
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts.items()
                if v != before[k]}
    want = 2 * per_forward * (HP64_AR + 1) - NO_GRAD_PRODUCTS
    if launched != {KERNEL: want}:
        raise AssertionError(f"train64f32 K1 fp32 step launched {launched}, "
                             f"not {want} {KERNEL}")
    ms = time_steps({label: res["step"]}, HP64_BATCH, card_line,
                    SMOKE_WINDOWS, SMOKE_STEPS)[label]

    # a forecast call: one model call without gradients, batch 8
    n = model.input_n_node
    x = torch.from_numpy(np.random.default_rng(SEED + 41).standard_normal(
        (HP64_BATCH, len(INPUT_K), n, F_STATIC + F_BC + F_DYN)).astype(
            np.float32)).to(device)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        before = dict(launch_counts)
        t = time.perf_counter()
        for _ in range(F32_FORWARDS):
            y = model(x)
        torch.cuda.synchronize()
        fc_ms = 1e3 * (time.perf_counter() - t) / F32_FORWARDS
    launched = {k: v - before[k] for k, v in launch_counts.items()
                if v != before[k]}
    if launched != {ELL_KERNEL: per_forward * F32_FORWARDS} or \
            y.shape != (HP64_BATCH, 1, n, F_DYN) or \
            not torch.isfinite(y).all():
        raise AssertionError(f"train64f32 forecast: {tuple(y.shape)}, "
                             f"launched {launched}")
    log("train64f32", f"step {ms:.2f} ms (batch {HP64_BATCH}, "
                      f"{HP64_BATCH * 1e3 / ms:.2f} samples/s), peak "
                      f"device memory {peak:.2f} GiB; forecast call (no "
                      f"grad, batch "
                      f"{HP64_BATCH}) {fc_ms:.2f} ms, {per_forward} "
                      f"{ELL_KERNEL} launches each ({card_line})")
    shapes = ell_step_shapes(model, res["step"], _grid_laplacian(cfg, geom),
                             card_line)
    cpu = grids_card_vs_cpu(device, cfg, params, F32_CONFIG, ar=F32_CHECK_AR,
                            batch=F32_CHECK_BATCH, dense_threshold=None,
                            phase="train64f32")
    seconds = time.perf_counter() - t0
    log("train64f32", f"phase {seconds:.1f} s")
    return {"launches": launches, "step": res["step"],
            "forecast": (per_forward * F32_FORWARDS, 0), "ms": ms,
            "peak_gib": peak, "forecast_ms": fc_ms, "shapes": shapes,
            "card_vs_cpu": cpu, "seconds": seconds}


def _rel_err_card(got, ref):
    """`rel_err` of a card tensor against a reference (numpy or a tensor),
    computed in fp64 on the card."""
    import torch

    ref = torch.as_tensor(np.ascontiguousarray(ref) if isinstance(
        ref, np.ndarray) else ref).to(got.device, torch.float64)
    return float((got.double() - ref).abs().max() / ref.abs().max())


def ell_step_shapes(model, step, laplacian, card_line, phase="train64f32",
                    name="HEALPix", k1=True):
    """Each (level, layout, width) shape one train step launches the ELL
    kernel at (recorded by wrapping `ell_spmm`; the layout L, or L^T's own
    for a non-symmetric L's backward), per launch, on the first columns
    of an x and a g drawn on the card at the level's widest shape: the
    ELL kernel against its plain version exactly, against scipy (L x,
    resp. L^T g) and, for L, backward through the operator against
    scipy's L^T g at the fp32 bar; cuSPARSE's fp32 CSR product of the
    same matrix and the bound of the function's work (`_ell_bound`); with
    `k1`, K1's fp32 regime too (the gather body: the K1 wrapper on the
    same operator's super-row arrays, x padded as its matvec pads it) and
    the plain version's time. Returns one entry per shape."""
    import types

    import torch
    import torch.nn.functional as F

    from deepsphere_weather_torch.ops import bcsr

    launched, kernel = set(), bcsr.ell_spmm

    def record(vals, cols, x, tables=None):
        launched.add((vals.data_ptr(), x.shape[1]))
        return kernel(vals, cols, x, tables)

    bcsr.ell_spmm = record
    try:
        step()
    finally:
        bcsr.ell_spmm = kernel
    ops = [c.bcsr for c in model.geometry.cheb_ops]
    layout_of = {}
    for lvl, o in enumerate(ops):
        if o is not None:
            layout_of[o.ell.vals.data_ptr()] = (lvl, "L")
            if not o.ell.symmetric:
                layout_of[o.ell.vals_t.data_ptr()] = (lvl, "L^T")
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(SEED + 42)
    shapes = sorted({layout_of[p] + (w,) for p, w in launched})
    rows, refs = [], {}
    for level, layout, width in shapes:
        op, L = ops[level], laplacian(level)
        n = L.shape[0]
        if level not in refs:
            # x and g at the level's widest shape, drawn on the card; each
            # shape takes their first columns, so one scipy product per
            # level and direction holds them all: L x, and L^T g (L's
            # backward, and L^T's own forward on g)
            wide = max(w for lv, _, w in shapes if lv == level)
            x, g = (torch.randn((n, wide), generator=gen, device=device)
                    for _ in range(2))
            refs[level] = (x, g, L @ x.cpu().numpy(),
                           L.T @ g.cpu().numpy())
        x, g, l_x, lt_g = refs[level]
        ell, mat, inp, ref = op.ell, L, x, l_x
        if layout == "L^T":
            ell = types.SimpleNamespace(vals=op.ell.vals_t,
                                        cols=op.ell.cols_t,
                                        tables=op.ell.tables_t)
            mat, inp, ref = L.T.tocsr(), g, lt_g
        inp = inp[:, :width].contiguous()
        label = f"{ELL_KERNEL} {name} level {level} {layout} x[{n}, {width}]"
        r = measure_ell(ell, mat, inp, device, label, plain_timed=k1)
        checks = [(_rel_err_card(r["y"], ref[:, :width]), "forward vs scipy")]
        if layout == "L":
            xg = inp.clone().requires_grad_()
            op.matvec(xg).backward(g[:, :width])
            checks.append((_rel_err_card(xg.grad, lt_g[:, :width]),
                           "backward vs scipy L^T g"))
        k1_ms = None
        if k1:
            _, a, idx, nz = op.forward_layout()
            x_pad = F.pad(inp, (0, (-width) % 128, 0, op.rows - n))
            checks.append((_rel_err_card(bcsr.bcsr_super_spmm(
                a, idx, x_pad, nz)[:n, :width], r["y"]),
                           f"{KERNEL} (gather body) vs {ELL_KERNEL}"))
            k1_ms = device_ms(lambda: bcsr.bcsr_super_spmm(a, idx, x_pad,
                                                            nz))
        for e, what in checks:
            if not e < BARS["fp32"]:
                raise AssertionError(f"{label}: {what} {e:.3e} breaks the "
                                     f"{BARS['fp32']:g} bar")
        rows.append({"level": level, "layout": layout, "width": width,
                     "ms": r["ms"], "host_ms": r["host_ms"],
                     "plain_ms": r["plain_ms"],
                     "library_ms": r["library_ms"], "k1_fp32_ms": k1_ms,
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "bytes_ms": r["bytes_ms"], "ops_ms": r["ops_ms"],
                     "max_abs_err": r["max_abs_err"],
                     "ell_width": r["ell_width"], "union_max": r["union_max"],
                     "block_rows_max": r["block_rows_max"],
                     "col_tile": r["col_tile"],
                     "ctas_per_sm": r["ctas_per_sm"]})
        log(phase, f"{label}: {r['ms']:.4f} ms per launch (bound "
                   f"{r['bound_ms']:.4f} ms by {r['bound_by']}, share "
                   f"{r['share_of_bound']:.3f}; cuSPARSE "
                   f"{r['library_ms']:.4f} ms"
                   + (f"; {KERNEL}'s gather body {k1_ms:.4f} ms; plain "
                      f"{r['plain_ms']:.4f} ms" if k1 else "")
                   + f"); ELL width {r['ell_width']}, union tables: largest "
                   f"{r['union_max']}, rows a block {r['block_rows_max']}, "
                   f"column tile {r['col_tile']}, {r['ctas_per_sm']} CTAs "
                   f"an SM; vs plain version max abs {r['max_abs_err']:.3e}, "
                   + ", ".join(f"{what} {e:.3e}" for e, what in checks)
                   + f" (bar {BARS['fp32']:g}) ({card_line})")
    keys = ("ms", "library_ms", "bound_ms") + (("k1_fp32_ms",) if k1 else ())
    total = {k: sum(r[k] for r in rows) for k in keys}
    log(phase, f"over the {name} step's {len(rows)} shapes, one launch "
               f"each: {ELL_KERNEL} {total['ms']:.4f} ms, cuSPARSE "
               f"{total['library_ms']:.4f} ms, "
               + (f"{KERNEL}'s gather body {total['k1_fp32_ms']:.4f} ms, "
                  if k1 else "")
               + f"bound {total['bound_ms']:.4f} ms ({card_line})")
    return rows


def _shipped_names():
    """The shipped configurations of SHIPPED_DIR, by file name."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                     "UNetSpherical", SHIPPED_DIR)
    return sorted(f[:-len(".json")] for f in os.listdir(d)
                  if f.endswith(".json"))


@clocked
def phase_shipped100km(device, card_line):
    """shipped100km (module docstring, 6c): every shipped Healpix_100km
    configuration at its own settings, one after another, each model freed
    before the next."""
    import gc

    import torch

    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.ops.bcsr import launch_counts

    t_phase = time.perf_counter()
    names = _shipped_names()
    per_forward = sum(PRODUCTS_PER_LEVEL[:2])
    out = {"launches": [0, 0], "remat": [0, 0], "forecast": [0, 0],
           "configs": {}, "shapes": {}, "card_vs_cpu": {}}
    batches, forecast_inputs = {}, {}
    for index, name in enumerate(names):
        t_cfg = time.perf_counter()
        cfg = _grids_config(f"{SHIPPED_DIR}/{name}")
        ms_, ts, ar = (cfg[k] for k in ("model_settings", "training_settings",
                                        "ar_settings"))
        model = grids_model(device, cfg, ts["numeric_precision"]).train()
        t_geom = time.perf_counter() - t_cfg
        geom = model.geometry
        kinds = ["dense" if o.dense is not None else
                 "ell" if o.bcsr is not None and o.bcsr.ell is not None
                 else "?" for o in geom.cheb_ops]
        voronoi = ms_["graph_type"] == "voronoi"
        if (ts["numeric_precision"] != "float32"
                or kinds != ["ell", "ell", "dense"]
                or any(o.bcsr.ell.symmetric == voronoi
                       for o in geom.cheb_ops[:2])):
            raise AssertionError(f"{name}: {ts['numeric_precision']}, "
                                 f"levels {kinds}")
        params = train_params(model, SEED + 50 + index)
        model.load_state_dict(params)
        n_calls = ar["ar_iterations"] + 1
        batch = ts["training_batch_size"]
        label = (f"{name} fp32 AR{ar['ar_iterations']} batch {batch} "
                 f"lr {ts['learning_rate']} clip {ts['gradient_clipping']}")
        # the config's own settings (Adam eps ADAM_EPS) on one synthetic
        # batch from SEED + 51, made once for every config of its window
        # and batch size
        indexer = ARIndexer.build(ar["input_k"], ar["output_k"],
                                  ar["forecast_cycle"], ar["ar_iterations"])
        batch_key = (indexer.window_size, model.input_n_node, batch)
        if batch_key not in batches:
            batches[batch_key] = train_batch(indexer, *batch_key[1:], device,
                                             SEED + 51)

        def steps(remat):
            return run_train(model, ar["ar_iterations"], batch,
                             SHIPPED_STEPS, label + " remat" * remat,
                             clip=ts["gradient_clipping"],
                             phase="shipped100km", lr=ts["learning_rate"],
                             indexer=indexer, data=batches[batch_key],
                             strategy=ts["ar_training_strategy"],
                             remat=remat, decreasing=False, memory=True)

        res = steps(remat=False)
        f, b = check_launches(res, ELL_KERNEL, per_forward, n_calls, label,
                              phase="shipped100km")
        out["launches"][0] += f
        out["launches"][1] += b

        # a forecast call: one model call without gradients
        n = model.input_n_node
        shape = (batch, len(ar["input_k"]), n, F_STATIC + F_BC + F_DYN)
        if shape not in forecast_inputs:
            forecast_inputs[shape] = torch.from_numpy(
                np.random.default_rng(SEED + 52).standard_normal(
                    shape).astype(np.float32)).to(device)
        x = forecast_inputs[shape]
        with torch.no_grad():
            model(x)
            torch.cuda.synchronize()
            before = dict(launch_counts)
            t = time.perf_counter()
            for _ in range(SHIPPED_FORWARDS):
                y = model(x)
            torch.cuda.synchronize()
            fc_ms = 1e3 * (time.perf_counter() - t) / SHIPPED_FORWARDS
        launched = {k: v - before[k] for k, v in launch_counts.items()
                    if v != before[k]}
        if launched != {ELL_KERNEL: per_forward * SHIPPED_FORWARDS} or \
                y.shape != (batch, 1, n, F_DYN) or \
                not torch.isfinite(y).all():
            raise AssertionError(f"{name} forecast: {tuple(y.shape)}, "
                                 f"launched {launched}")
        out["forecast"][0] += per_forward * SHIPPED_FORWARDS
        row = {"step_ms": res["ms"][-1], "first_step_ms": res["ms"][0],
               "losses": res["losses"].tolist(),
               "first_peak_gib": res["first_peak_gib"],
               "peak_gib": res["peak_gib"], "step_gib": res["step_gib"],
               "forecast_ms": fc_ms, "geometry_s": t_geom}
        log("shipped100km", f"{label}: levels {geom.n_nodes} "
                            f"({', '.join(kinds)}), pools "
                            f"{type(geom.pools[0]).__name__}/"
                            f"{type(geom.unpools[0]).__name__}; losses "
                            f"{res['losses'][0]:.6g} -> "
                            f"{res['losses'][-1]:.6g}; step "
                            f"{res['ms'][-1]:.2f} ms "
                            f"({batch * 1e3 / res['ms'][-1]:.2f} samples/s; "
                            f"the first {res['ms'][0]:.2f} ms); "
                            f"peak device memory {res['first_peak_gib']:.2f} "
                            f"GiB over the first step, the last step's own "
                            f"{res['step_gib']:.2f} GiB (peak "
                            f"{res['peak_gib']:.2f}); forecast call (no "
                            f"grad, batch {batch}) {fc_ms:.2f} ms, "
                            f"{per_forward} {ELL_KERNEL} launches; geometry "
                            f"{t_geom:.1f} s ({card_line})")
        if name in SHIPPED_SHAPES:
            out["shapes"][name] = ell_step_shapes(
                model, res["step"], _grid_laplacian(cfg, geom), card_line,
                phase="shipped100km", name=name, k1=False)
        res.pop("step")
        if name == SHIPPED_REMAT:
            # the same steps with remat from the same weights
            model.load_state_dict(params)
            rem = steps(remat=True)
            rem.pop("step")
            # the recompute falls in the backward
            out["remat"] = list(check_launches(
                rem, ELL_KERNEL, per_forward, n_calls, label + " remat",
                phase="shipped100km", remat=True))
            want = sum(out["remat"]) // SHIPPED_STEPS
            # a one-element gradient (a ReZero weight) against the largest
            # gradient, as remat16 holds it
            top = max(float(r.abs().max()) for r in res["grads"].values())
            e_loss = rel_err(rem["per_iter"][0], res["per_iter"][0])
            e_grad, key = grads_close(
                rem["grads"], res["grads"],
                {k: top for k, r in res["grads"].items() if r.numel() == 1},
                REMAT_TOL, f"{name} first step with vs without remat")
            if not e_loss <= REMAT_TOL:
                raise AssertionError(f"{name} remat: losses {e_loss:.3e}")
            row["remat"] = {"step_ms": rem["ms"][-1],
                            "first_peak_gib": rem["first_peak_gib"],
                            "peak_gib": rem["peak_gib"],
                            "step_gib": rem["step_gib"], "losses": e_loss,
                            "gradients": e_grad}
            log("shipped100km", f"{label} with remat: {want} "
                                f"{ELL_KERNEL} launches a step (the "
                                f"recompute's {per_forward * n_calls} more; "
                                f"forward + backward as counted over "
                                f"{SHIPPED_STEPS} steps {out['remat'][0]} + "
                                f"{out['remat'][1]}), no other kernel; "
                                f"first step vs without "
                                f"remat: losses {e_loss:.3e}, gradients "
                                f"{e_grad:.3e} ({key}) (bar {REMAT_TOL:g}); "
                                f"step {rem['ms'][-1]:.2f} ms vs "
                                f"{res['ms'][-1]:.2f} ms without; the last "
                                f"step's own peak {rem['step_gib']:.2f} GiB "
                                f"vs {res['step_gib']:.2f} GiB without (peak "
                                f"over the first step "
                                f"{rem['first_peak_gib']:.2f} vs "
                                f"{res['first_peak_gib']:.2f} GiB) "
                                f"({card_line})")
            del rem
        # the allocator keeps its cache for the next configuration: after
        # torch.cuda.empty_cache() its steps would map their memory again
        # (expandable segments), which no trainer does
        del model, x, y
        gc.collect()
        out["configs"][name] = row
        if name in SHIPPED_CHECK:
            out["card_vs_cpu"][name] = grids_card_vs_cpu(
                device, cfg, params, name, ar=F32_CHECK_AR,
                batch=F32_CHECK_BATCH, dense_threshold=None,
                phase="shipped100km")
        out["configs"][name]["seconds"] = time.perf_counter() - t_cfg
    if sorted(out["card_vs_cpu"]) != sorted(SHIPPED_CHECK) or \
            len(names) != 18:
        raise AssertionError(f"shipped100km ran {names}, held "
                             f"{sorted(out['card_vs_cpu'])} card vs CPU")
    rows = out["configs"].values()
    log("shipped100km", f"{len(names)} configs, {SHIPPED_STEPS} steps each: "
                        f"step {min(r['step_ms'] for r in rows):.2f}-"
                        f"{max(r['step_ms'] for r in rows):.2f} ms, the last "
                        f"step's own peak "
                        f"{min(r['step_gib'] for r in rows):.2f}-"
                        f"{max(r['step_gib'] for r in rows):.2f} GiB, peak "
                        f"over the first step "
                        f"{max(r['first_peak_gib'] for r in rows):.2f} GiB at "
                        f"most; {out['launches'][0]} + {out['launches'][1]} "
                        f"{ELL_KERNEL} launches; phase "
                        f"{time.perf_counter() - t_phase:.1f} s ({card_line})")
    return out


# ---------------------------------------------------------------------------
# ens64: the shipped Healpix_100km DeepEnsemble at its own settings
# ---------------------------------------------------------------------------

def _steering(model):
    """What `steer` replaces on `model` (its ReLUs and its geometry's
    pools): a function that puts it back."""
    from deepsphere_weather_torch.models import ConvBlock

    acts = [(m, m.act_fun) for m in model.modules()
            if isinstance(m, ConvBlock) and m.act]
    geometry = model.geometry

    def undo():
        for m, fn in acts:
            m.act_fun = fn
        model.geometry = geometry
    return undo


def ens64_store():
    """ens64 (b)'s toy HEALPix-64 store, written on the host by
    `cli.prepare_toy_data` (ENS64_STORE_STEPS six-hour steps, seed SEED)
    under a temporary root: {"root", "data", "seconds"}."""
    from deepsphere_weather_torch.cli import prepare_toy_data

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dsw_ens64_")
    try:
        data = os.path.join(root, "data")
        prepare_toy_data.main(data, subdivisions=BIG_SUBDIV,
                              n_timesteps=ENS64_STORE_STEPS, seed=SEED,
                              verbose=False)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    return {"root": root, "data": data, "seconds": time.perf_counter() - t0}


@clocked
def phase_ens64(device, card_line, single, store):
    """ens64 (module docstring, 6d): the shipped Healpix_100km MaxPool knn
    configuration's DeepEnsemble at its own settings with remat, (a) the
    member step driven directly, (b) `run_deep_ensemble` end to end over
    `store` (`ens64_store`, whose root it removes). `single` is
    shipped100km's reading of the same configuration's single remat step
    (its `remat` row: the second step's own peak and ms)."""
    t_phase = time.perf_counter()
    try:
        out = _ens64_members(device, card_line, single)
        ensemble = _ens64_deep_ensemble(device, card_line, store["root"],
                                        store["data"], store["seconds"])
    finally:
        shutil.rmtree(store["root"], ignore_errors=True)
    out.update(ensemble_launches=ensemble["launches"],
               ensemble_seconds=ensemble["seconds"])
    log("ens64", f"phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _ens64_members(device, card_line, single):
    """ens64 (a): the member step of ENS64_MEMBERS members (its own peak
    against `single`'s), profiled, member 0 against the single remat step
    on its weights, and the largest stack; the ELL kernel at the folded
    width."""
    import gc

    import torch

    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine import (
        Adam,
        make_member_train_step,
        make_train_step,
    )
    from deepsphere_weather_torch.models import MemberStack
    from deepsphere_weather_torch.utils.profiling import profile_step
    from torch_steer import steer

    cfg = _grids_config(ENS64_CONFIG)
    ts, ar = cfg["training_settings"], cfg["ar_settings"]
    model = grids_model(device, cfg, ts["numeric_precision"]).train()
    geom = model.geometry
    kinds = ["dense" if o.dense is not None else
             "ell" if o.bcsr is not None and o.bcsr.ell is not None
             else "?" for o in geom.cheb_ops]
    if ts["numeric_precision"] != "float32" or \
            kinds != ["ell", "ell", "dense"]:
        raise AssertionError(f"ens64: {ts['numeric_precision']}, levels "
                             f"{kinds}")
    M, batch = ENS64_MEMBERS, ts["training_batch_size"]
    n_calls = ar["ar_iterations"] + 1
    per_forward = sum(PRODUCTS_PER_LEVEL[:2])
    indexer = ARIndexer.build(ar["input_k"], ar["output_k"],
                              ar["forecast_cycle"], ar["ar_iterations"])
    data = train_batch(indexer, model.input_n_node, batch, device, SEED + 80)
    _, area_w, w = train_setup(model, ar["ar_iterations"])
    members = [train_params(model, ENS64_SEED + m) for m in range(M)]
    label = (f"{ENS64_CONFIG} fp32 AR{ar['ar_iterations']} batch {batch} "
             f"lr {ts['learning_rate']} clip {ts['gradient_clipping']} "
             "remat")

    def adam(params, member_axis=False):
        # the config's lr and clipping; ens16's Adam eps (ENS_CHECK_EPS)
        return Adam(params, lr=ts["learning_rate"], eps=ENS_CHECK_EPS,
                    gradient_clipping=ts["gradient_clipping"],
                    member_axis=member_axis)

    def member_step(states):
        stack = MemberStack.from_states(model, states)
        return stack, make_member_train_step(
            stack, indexer, adam(stack.parameters(), member_axis=True),
            n_calls, ts["ar_training_strategy"], remat=True)

    # every step on the fixed batch, its launch split kept by path
    run, hook = split_launches(model, n_calls)
    per_step = {}

    def call(step, path):
        out, split = run(lambda: step(data, w, area_w))
        per_step.setdefault(path, []).append(split)
        return out

    def recorded(step, path):
        """call() with the widths of its ELL launches, in order."""
        out = []
        widths = record_widths(lambda: out.append(call(step, path)),
                               ELL_KERNEL)
        return out[0], widths

    def timed_peak(fn):
        """(own peak GiB past the call's start, ms, GiB allocated at its
        start) of fn(); `reserved` keeps the allocator's reserved peak."""
        t = [0.0]

        def timed():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t[0] = 1e3 * (time.perf_counter() - t0)
        base, peak = _peak_over(timed)
        reserved[0] = torch.cuda.max_memory_reserved() / 2 ** 30
        return (peak - base) / 2 ** 30, t[0], base / 2 ** 30

    reserved = [0.0]

    # the member step: its first step on member 0's ReLU and max-pool
    # decisions recorded (`steer`, member 0's alone), then unsteered
    path = f"ens64_{M}_members"
    stack, step = member_step(members)
    undo = _steering(model)
    decisions, _ = steer(model, None, M, member=0)
    try:
        (_, per_iter), member_widths = recorded(step, path)
    finally:
        undo()
    mem0 = {"per_iter": per_iter[0].detach().cpu().double(),
            "grads": {k: p.grad[0].detach().cpu().double()
                      for k, p in stack.named_parameters()},
            "params": {k: p[0].detach().cpu().double()
                       for k, p in stack.named_parameters()}}
    # the second step timed by `profile_step` (host clock), then a third
    # under torch.profiler; the own peak past the second's start covers
    # both
    prof = {}
    with tempfile.TemporaryDirectory() as tmp:
        member_gib, _, base_gib = timed_peak(lambda: prof.update(
            profile_step(lambda: call(step, path), n=1, warmup=0,
                         trace_dir=tmp)))
        rows = _trace_rows(os.path.join(tmp, "trace.json"))
    member_ms, busy = 1e3 * prof["median_s"], sum(r[0] for r in rows)
    del stack, step
    gc.collect()

    # member 0 against the single remat step on its weights and batch,
    # the single step on member 0's decisions
    model.load_state_dict(members[0])
    step = make_train_step(model, indexer, adam(model.parameters()), n_calls,
                           ts["ar_training_strategy"], remat=True)
    undo = _steering(model)
    own, gaps = steer(model, decisions)
    try:
        (_, per_single), single_widths = recorded(step, "ens64_single")
    finally:
        undo()
    n_dec = (len(decisions), len(own))
    del decisions, own, step
    one = {"per_iter": per_single.detach().cpu().double(),
           "grads": grads_of(model),
           "params": {k: p.detach().cpu().double()
                      for k, p in model.named_parameters()}}
    gc.collect()

    # one launch a product for every member: M times the single widths,
    # but the first convolution's 2 products on the shared batch (in the
    # forward and in its recompute); the forward's products, the
    # recompute's and the backward's
    n_launch = 3 * per_forward * n_calls - NO_GRAD_PRODUCTS
    shared = [i for i, (a, b) in enumerate(zip(member_widths,
                                               single_widths)) if a != M * b]
    if (len(member_widths) != n_launch or len(single_widths) != n_launch
            or len(shared) != 2 * NO_GRAD_PRODUCTS
            or any(member_widths[i] != single_widths[i] for i in shared)):
        raise AssertionError(f"ens64 widths {member_widths} vs single "
                             f"{single_widths}")
    bar = ENS64_PEAK_BAR * M * single["step_gib"]
    log("ens64", f"{label}: {M} members (seeds {ENS64_SEED}+m) in one member "
                 f"step, each ELL launch at {M}x the single step's width "
                 f"but the {len(shared)} on the shared batch: "
                 f"{sorted(set(member_widths))} vs single "
                 f"{sorted(set(single_widths))}; the second step "
                 f"{member_ms:.2f} ms ({M * batch * 1e3 / member_ms:.2f} "
                 f"member samples/s; shipped100km's single remat step, "
                 f"before the smoke's host threads, {single['step_ms']:.2f} "
                 f"ms); the own peak of steps 2-3 {member_gib:.2f} GiB past "
                 f"{base_gib:.2f} GiB (at most {reserved[0]:.2f} GiB "
                 f"reserved) vs shipped100km's single remat step's "
                 f"{single['step_gib']:.2f} GiB "
                 f"({member_gib / single['step_gib']:.2f}x, bar "
                 f"{ENS64_PEAK_BAR} x {M} = {bar / single['step_gib']:.3f}x) "
                 f"({card_line})")
    if not (member_gib <= bar and base_gib + member_gib < 80e9 / 2 ** 30):
        raise AssertionError(f"ens64 {M} members: own peak {member_gib:.2f} "
                             f"GiB past {base_gib:.2f}, bar {bar:.2f} GiB")
    log("ens64", f"profile_step of the {M}-member step: the third step "
                 f"traced: device busy {busy:.2f} ms, "
                 f"{100 * busy / member_ms:.1f}% of the second step's host "
                 f"time, {sum(r[1] for r in rows)} kernel launches "
                 f"({card_line})")
    for ms, count, name in rows[:PROFILE_TOP]:
        log("ens64", f"{100 * ms / max(busy, 1e-9):5.1f}%  {ms:9.3f} ms  "
                     f"{count:5d}x  {name[:90]}")
    worst = {"losses": rel_err(mem0["per_iter"].numpy(),
                               one["per_iter"].numpy())}
    keys = {"losses": "per_iter"}
    for part in ("grads", "params"):
        top = max(float(r.abs().max()) for r in one[part].values())
        worst[part], keys[part] = grads_close(
            mem0[part], one[part],
            {k: top for k, r in one[part].items() if r.numel() == 1},
            ENS_TOL, f"ens64 member 0 {part} vs its single step")
    log("ens64", f"member 0 vs the single remat step on its weights and "
                 f"batch (Adam eps {ENS_CHECK_EPS:g}, clipping "
                 f"{ts['gradient_clipping']}), the single step on member 0's "
                 f"{n_dec[0]} ReLU and max-pool decisions (forward and "
                 f"recompute; {len(gaps)} differed from its own, up to "
                 f"{max(gaps, default=0.0):.2e} from their kink or tie, bar "
                 f"{KINK_TOL:g}): " + ", ".join(
                     f"{k} {e:.3e} ({keys[k]})" for k, e in worst.items())
                 + f" (bar {ENS_TOL:g})")
    if n_dec[0] != n_dec[1] or max(gaps, default=0.0) > KINK_TOL or \
            not all(e <= ENS_TOL for e in worst.values()):
        raise AssertionError(f"ens64 member 0 vs single: {worst}, "
                             f"decisions {n_dec}, gaps {gaps}")

    # the largest stack: the M whose own peak, predicted from M members'
    # per member, stays under ENS64_BUDGET_GIB with what the card holds
    # at the step's start; one step of it, on the allocator settings the
    # port asks for (`main` calls `ask_expandable_segments` first, as the
    # port's entry points do: on the default segments 7 members failed at
    # 61.3 GiB allocated with 16.4 GiB reserved and unallocated, H100
    # 80GB HBM3, 700 W)
    per_member = member_gib / M
    m_max = int((ENS64_BUDGET_GIB - base_gib) // per_member)
    while base_gib + m_max * per_member >= ENS64_BUDGET_GIB:
        m_max -= 1
    stack, step = member_step(
        [train_params(model, ENS64_SEED + m) for m in range(m_max)])
    max_gib, max_ms, max_base = timed_peak(
        lambda: call(step, f"ens64_{m_max}_members"))
    del stack, step
    gc.collect()
    torch.cuda.empty_cache()
    hook.remove()
    log("ens64", f"the largest stack under {ENS64_BUDGET_GIB:g} GiB "
                 f"predicted ({per_member:.3f} GiB a member at {M}, "
                 f"{base_gib:.2f} GiB held before), on the port's own "
                 f"allocator settings: {m_max} members, one step "
                 f"{max_ms:.2f} ms, own peak {max_gib:.2f} GiB past "
                 f"{max_base:.2f} GiB vs predicted "
                 f"{m_max * per_member:.2f} GiB "
                 f"({max_gib / (m_max * per_member):.3f}x), at most "
                 f"{reserved[0]:.2f} GiB reserved ({card_line})")
    launches = {p: check_launches({"per_step": s}, ELL_KERNEL, per_forward,
                                  n_calls, p, phase="ens64",
                                  remat=True)
                for p, s in per_step.items()}

    # the ELL kernel at the member step's widest level-0 width
    L0 = _grid_laplacian(cfg, geom)(0)
    width = M * batch * max(WIDTH_FEATURES)
    if width not in member_widths:
        raise AssertionError(f"ens64: no launch at x width {width}")
    x = torch.randn((L0.shape[0], width), device=device,
                    generator=torch.Generator(device=device).manual_seed(
                        SEED + 81))
    r = measure_ell(geom.cheb_ops[0].bcsr.ell, L0, x, device,
                    f"ens64 x[{L0.shape[0]}, {width}]", plain_timed=False)
    # scipy on the first MATVEC_WIDTH columns (the plain version holds
    # every column, exactly)
    e = _rel_err_card(r["y"][:, :MATVEC_WIDTH],
                      L0 @ x[:, :MATVEC_WIDTH].cpu().numpy())
    if not e < BARS["fp32"]:
        raise AssertionError(f"ens64 folded width: vs scipy {e:.3e}")
    folded = {k: r[k] for k in ("ms", "host_ms", "library_ms", "bound_ms",
                                "bound_by", "max_abs_err", "col_tile",
                                "ctas_per_sm")}
    folded.update(width=width, scipy_rel_err=e)
    log("ens64", f"{ELL_KERNEL} at the {M}-member folded width x["
                 f"{L0.shape[0]}, {width}]: {r['ms']:.4f} ms per launch "
                 f"(host enqueue {r['host_ms']:.4f} ms; bound "
                 f"{r['bound_ms']:.4f} ms by {r['bound_by']}, share "
                 f"{r['share_of_bound']:.3f}; torch.sparse.mm "
                 f"{r['library_ms']:.4f} ms); column tile {r['col_tile']}, "
                 f"{r['ctas_per_sm']} CTAs an SM; vs plain version max abs "
                 f"{r['max_abs_err']:.3e}, vs scipy {e:.3e} (its first "
                 f"{MATVEC_WIDTH} columns) ({card_line})")
    del x, r, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "folded": folded,
            "single_gib": single["step_gib"], "member_gib": member_gib,
            "m_max": m_max, "max_gib": max_gib, "member_ms": member_ms,
            "single_ms": single["step_ms"], "busy_ms": busy,
            "member_check": worst}


def _ens64_deep_ensemble(device, card_line, root, data, data_s):
    """ens64 (b): `cli.experiments.run_deep_ensemble(member_parallel=True)`
    with ENS64_MEMBERS members on the shipped config (remat on, its epochs,
    periods and scoring cut) under `root`, over the toy HEALPix-64 store
    `data` that `cli.prepare_toy_data` wrote in `data_s` seconds: every
    member store, the ensemble and median stores finite and of their
    shapes, the median's RMSE and the ensemble's CRPS finite, only the ELL
    kernel launched, each checkpointed AR iteration recomputed once;
    seconds by stage."""
    import torch

    import deepsphere_weather_torch.engine as engine
    from deepsphere_weather_torch.cli import experiments
    from deepsphere_weather_torch.engine import step as step_mod
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    secs = {}
    cfg = _grids_config(ENS64_CONFIG)
    cfg["training_settings"].update(epochs=1, remat=True,
                                    scoring_interval=ENS64_SCORING,
                                    **ENS64_PERIODS)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    checkpoints, runs, out = [0], [0], {}
    trainer, members, checkpoint = (engine.AutoregressiveTraining,
                                    experiments._train_members_parallel,
                                    step_mod.checkpoint)

    def timed(name, fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                out[name] = fn(*a, **k)
                return out[name]
            finally:
                secs[name] = time.perf_counter() - t
        return call

    def counted(fn, *a, **k):
        checkpoints[0] += 1

        def again(*a, **k):
            runs[0] += 1
            return fn(*a, **k)
        return checkpoint(again, *a, **k)

    engine.AutoregressiveTraining = timed("train", trainer)
    experiments._train_members_parallel = timed("members", members)
    step_mod.checkpoint = counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = experiments.run_deep_ensemble(
            cfg_path, data, os.path.join(root, "exp"),
            n_members=ENS64_MEMBERS,
            ar_iterations_prediction=CLI_AR_PREDICT,
            member_parallel=True, device=device)
    finally:
        engine.AutoregressiveTraining = trainer
        experiments._train_members_parallel = members
        step_mod.checkpoint = checkpoint
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    n = 12 * BIG_SUBDIV ** 2
    stores = {f"member {m}": np.stack(
        [fc.variables[v][...] for v in fc.feature_order], -1)
        for m, fc in enumerate(out["members"])}
    ens = res["ensemble"]
    stores["ensemble"] = np.stack([ens.variables[v][...]
                                   for v in ens.feature_order], -1)
    med = res["median"]
    stores["median"] = np.stack([med.variables[v][...]
                                 for v in med.feature_order], -1)
    n_frt = stores["median"].shape[0]
    shape = (n_frt, CLI_AR_PREDICT + 1, n, F_DYN)
    rmse = np.asarray(res["global_skill"]["RMSE"])
    crps = np.asarray(res["probabilistic_skill"]["CRPS"])
    recomputed = runs[0] - checkpoints[0]
    bad = [k for k, a in stores.items()
           if a.shape != ((ENS64_MEMBERS,) + shape if k == "ensemble"
                          else shape) or not np.isfinite(a).all()]
    if (bad or len(out["members"]) != ENS64_MEMBERS or not n_frt
            or not checkpoints[0] or recomputed != checkpoints[0]
            or launches[ELL_KERNEL] == 0
            or sum(launches.values()) != launches[ELL_KERNEL]
            or not np.isfinite(rmse).all()
            or not np.isfinite(crps).all()):
        raise AssertionError(
            f"ens64 run_deep_ensemble: stores not finite or of their "
            f"shapes {bad} ({ {k: a.shape for k, a in stores.items()} }),"
            f" {checkpoints[0]} checkpointed AR iterations, "
            f"{recomputed} recomputed, launches {launches}, RMSE "
            f"{rmse}, CRPS {crps}")
    log("ens64", f"run_deep_ensemble(member_parallel=True), "
                 f"{ENS64_MEMBERS} members, {ENS64_CONFIG} at its own "
                 f"settings with remat, 1 epoch over a toy HEALPix-"
                 f"{BIG_SUBDIV} store ({ENS64_STORE_STEPS} six-hour "
                 f"steps, seed {SEED}; periods {ENS64_PERIODS}, scored "
                 f"every {ENS64_SCORING} updates): {recomputed} AR "
                 f"iterations recomputed in the backward; member, "
                 f"ensemble {stores['ensemble'].shape} and median "
                 f"{shape} stores finite; RMSE lead 1 "
                 f"{np.round(rmse[1], 4).tolist()} -> lead "
                 f"{CLI_AR_PREDICT} {np.round(rmse[-1], 4).tolist()}, "
                 f"CRPS lead {CLI_AR_PREDICT} "
                 f"{np.round(crps[-1], 4).tolist()}; "
                 f"{launches[ELL_KERNEL]} {ELL_KERNEL} launches, no "
                 "other kernel")
    seconds = {"data (on the host, beside the rank phases)": data_s,
               "train": secs["train"],
               "member predictions": secs["members"] - secs["train"],
               "ensemble, median and verification":
               wall - secs["members"]}
    log("ens64", "wall seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f" ({card_line})")
    return {"launches": launches[ELL_KERNEL], "seconds": seconds}


# ---------------------------------------------------------------------------
# Node- and data-parallel training (spawned ranks sharing the card)
# ---------------------------------------------------------------------------

def _rank_main(rank, world, out_dir, tasks):
    """One spawned rank: join the `gloo` group (ranks share one card, and
    NCCL refuses two ranks on one device), run each (task, kwargs), and
    pickle the results."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    joined = time.time()
    try:
        results = [task(rank, **kw) for task, kw in tasks]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((joined, results), f)


def run_ranks(world, tasks):
    """The tasks on `world` spawned ranks; [rank][task] results. A rank
    that raises fails the call (the others are stopped); so does a run
    past RANKS_LIMIT_S, after every rank is killed."""
    import torch
    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        t_spawn = time.time()
        ctx = mp.start_processes(_rank_main, args=(world, out_dir, tasks),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + RANKS_LIMIT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"{world} ranks did not end within "
                                   f"{RANKS_LIMIT_S} s")
        t_end, joined, results = time.time(), [], []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                t, res = pickle.load(f)
            joined.append(t)
            results.append(res)
    log("ranks", f"{world} ranks: {max(joined) - t_spawn:.1f} s from the "
                 f"spawn to the last rank's joining its group, then "
                 f"{t_end - max(joined):.1f} s of tasks ({len(tasks)})")
    return results


def _sharded_model(mesh, subdiv, param_seed, precision="bfloat16",
                   dense_threshold=None, batch_norm=False):
    """The flagship at `subdiv` with rank 0's seeded weights on every rank
    and this rank's node shard of the geometry (level 0 row-sharded on a
    node mesh)."""
    from deepsphere_weather_torch.models import shard_geometry
    from deepsphere_weather_torch.ops import ShardedBlockSparseOperator
    from deepsphere_weather_torch.weights import broadcast_params

    model = build_flagship(mesh.device, subdiv, precision=precision,
                           dense_threshold=dense_threshold,
                           batch_norm=batch_norm).train()
    model.load_state_dict(train_params(model, param_seed))
    broadcast_params(model, mesh)
    n = model.input_n_node
    model.geometry = shard_geometry(model.geometry, mesh)
    if mesh.n_node > 1 and not isinstance(model.geometry.cheb_ops[0].bcsr,
                                          ShardedBlockSparseOperator):
        raise AssertionError("level 0 must run the row-sharded operator")
    return model, n


def rank_train(rank, device, subdiv, n_data, n_node, ar_iters, batch,
               n_steps, param_seed, check_products=False):
    """One rank of the sharded main path: n_steps of make_train_step(mesh)
    on its shard of the fixed batch of `run_train`, counts from 0. Per
    step: global losses, launches forward and backward (a forward hook
    reads the counters), gathers of each model call, host time; the
    parameters after, peak device memory."""
    import torch

    from deepsphere_weather_torch.engine import make_train_step
    from deepsphere_weather_torch.parallel import (
        make_mesh,
        node_range,
        shard_batch,
    )

    mesh = make_mesh(n_data=n_data, n_node=n_node, device=device)
    if mesh is None:          # idle in this task
        return None
    model, n = _sharded_model(mesh, subdiv, param_seed)
    v0, v1 = node_range(n, mesh)
    indexer, area_w, w = train_setup(model, ar_iters)
    data = shard_batch(train_batch(indexer, n, batch, mesh.device, SEED + 8),
                       mesh)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=ADAM_EPS)
    step = make_train_step(model, indexer, opt, ar_iters + 1, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0
    res = _counted_steps(model, lambda: step(data, w, area_w)[1].cpu().numpy(),
                         n_steps)
    out = {"mesh": (mesh.data_rank, mesh.node_rank), "node_range": (v0, v1),
           "per_iter": np.stack(res.pop("outs")),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params": torch_flat(model), **res}
    if check_products:
        out["products"] = check_sharded_products(
            model, lambda: step(data, w, area_w),
            lambda level: _laplacian(subdiv >> level), f"HEALPix-{subdiv}")
    return out


def rank_grads(rank, device, subdiv, n_data, n_node, batch,
               batch_norm=False):
    """The first fp32 step of one rank on an n_data x n_node mesh (level 0
    block-sparse fp32: the ELL kernel's row range on a node mesh), from
    `phase_train_check`'s weights and batch (with BatchNorm: statistics
    over the mesh): the global per-iteration losses make_train_step
    returns and the gradients, reduced over the mesh, that Adam steps
    on."""
    import torch

    from deepsphere_weather_torch.engine import make_train_step
    from deepsphere_weather_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(n_data=n_data, n_node=n_node, device=device)
    if mesh is None:          # idle in this task
        return None
    model, n = _sharded_model(mesh, subdiv, SEED + 6, "float32",
                              FP32_DENSE_THRESHOLD, batch_norm)
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = shard_batch(train_batch(indexer, n, batch, mesh.device, SEED + 7),
                       mesh)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=ADAM_EPS)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(grads_of(model)))
    _, per_iter = make_train_step(model, indexer, opt, TRAIN_AR + 1,
                                  mesh=mesh)(data, w, area_w)
    return {"mesh": (mesh.data_rank, mesh.node_rank),
            "per_iter": per_iter.cpu().numpy(), "grads": grads}


def single_grads(device, subdiv, batch, batch_norm=False):
    """`rank_grads`' step in one process: the reference. With BatchNorm a
    norm bias that feeds another BatchNorm is held against its block's
    norm scale (its gradient cancels, `cancelling_norm_biases`)."""
    from deepsphere_weather_torch.engine import make_ar_loss_fn
    from torch_grad_terms import cancelling_norm_biases, term_sums

    model = build_flagship(device, subdiv, precision="float32",
                           dense_threshold=FP32_DENSE_THRESHOLD,
                           batch_norm=batch_norm).train()
    model.load_state_dict(train_params(model, SEED + 6))
    sums = term_sums(model)
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, batch, device, SEED + 7)
    total, per_iter = make_ar_loss_fn(model, indexer, TRAIN_AR + 1)(data, w,
                                                                    area_w)
    total.backward()
    grads = grads_of(model)
    for k, scale_key in cancelling_norm_biases(model).items():
        sums[k] = float(grads[scale_key].abs().max())
    return per_iter.detach().cpu().numpy(), grads, sums


def check_sharded_products(model, step, laplacian, name):
    """Every level's K2 at each width one sharded step launched it,
    forward and backward: against its plain version on the same input
    (bf16 bar: the tensor cores sum in another order) and against scipy's
    rows (`laplacian`: level -> the level's scipy L); each launch had its
    slot list. The widths are the launches' own: a member step folds its
    members into them (K5 over K2). All ranks run the same products, in
    one order (the backward gathers)."""
    import torch

    from deepsphere_weather_torch.ops import bcsr

    launched = set()
    kernel = bcsr.bcsr_super_spmm_rows

    def record_launch(a, idx, x, s0, s1, nz=None):
        if nz is None:
            raise AssertionError("a K2 launch of the step had no slot list")
        launched.add((a.data_ptr(), x.shape[1], x.dtype))
        return kernel(a, idx, x, s0, s1, nz)

    bcsr.bcsr_super_spmm_rows = record_launch
    try:
        step()
    finally:
        bcsr.bcsr_super_spmm_rows = kernel
    ops = [c.bcsr for c in model.geometry.cheb_ops]
    level_of = {}
    for level, op in enumerate(ops):
        if op is not None:
            for layout in (op.forward_layout(), op.transpose_layout()):
                level_of[layout[1].data_ptr()] = level
    device = next(model.parameters()).device
    worst, lines = {"plain": 0.0, "scipy": 0.0}, []
    products = sorted({(level_of[ptr], width)
                       for ptr, width, _ in launched})
    for level, width in products:
        op, L = ops[level], laplacian(level)
        n, v0, v1 = L.shape[0], op.v0, op.v1
        dt = torch.bfloat16          # the flagship's bf16 activations
        rng = np.random.default_rng(SEED + 13 + level * 100003 + width)
        x = torch.from_numpy(rng.standard_normal((n, width)).astype(
            np.float32)).to(device, dt)
        g = torch.from_numpy(rng.standard_normal((n, width)).astype(
            np.float32)).to(device, dt)
        errs = {}
        for what, layout, inp in (("forward", op.forward_layout(), x),
                                  ("backward", op.transpose_layout(), g)):
            _, a, idx, nz, r0, full_rows = layout
            inp_fit = torch.nn.functional.pad(inp, (0, 0, 0, full_rows - n))
            y = kernel(a, idx, inp_fit, 0, a.shape[0], nz)
            errs[what + " plain"] = rel_err(y.float().cpu(), bcsr.
                bcsr_super_spmm_rows_reference(a, idx, inp_fit, 0, a.shape[0],
                                               nz).float().cpu())
        # through the operator: its forward rows and x.grad of <L x, g>
        xg = x[v0:v1].clone().requires_grad_()
        y = op.matvec(xg)
        y.backward(g[v0:v1])
        errs["forward scipy"] = rel_err(y.detach().float().cpu().numpy(), (
            L @ x.float().cpu().numpy())[v0:v1])
        errs["backward scipy"] = rel_err(xg.grad.float().cpu().numpy(), (
            L.T @ g.float().cpu().numpy())[v0:v1])
        label = f"{name} level {level} width {width}"
        if not all(e < BARS["bf16"] for e in errs.values()):
            raise AssertionError(f"K2 {label}: {errs}")
        worst["plain"] = max(worst["plain"], errs["forward plain"],
                             errs["backward plain"])
        worst["scipy"] = max(worst["scipy"], errs["forward scipy"],
                             errs["backward scipy"])
        lines.append(f"{label} rows [{v0}, {v1}): " + ", ".join(
            f"{k} {e:.3e}" for k, e in errs.items()))
    return {"lines": lines, "worst": worst, "n_products": len(products),
            "n_shapes": len(launched), "shapes": products}


def _log_products(phase, mesh, p):
    for line in p["lines"]:
        log(phase, f"K2 {line}")
    log(phase, f"rank {mesh}: {p['n_products']} (level, width) products of "
               f"a sharded step, forward and backward: worst rel err vs "
               f"plain version {p['worst']['plain']:.3e}, vs scipy's rows "
               f"{p['worst']['scipy']:.3e} (bar {BARS['bf16']:g}); from all "
               f"{p['n_shapes']} launch shapes")


def _check_rank_runs(phase, ranks, ref_per_iter, per_forward, n_calls):
    """The checks of a sharded training run, rank by rank: its
    per-iteration losses against the single-process run's first steps
    (SLICE_TOL), exactly per_forward * n_calls forward and that minus
    NO_GRAD_PRODUCTS backward K2 launches per step and nothing else, one
    gather per Laplacian product of every level in each model call (dense
    levels gather too); and parameters identical
    across ranks. Returns (forward, backward) K2 launches over ranks."""
    total = [0, 0]
    for r in ranks:
        label = f"rank {r['mesh']} nodes {r['node_range']}"
        e = rel_err(r["per_iter"], ref_per_iter[:len(r["per_iter"])])
        if not e <= SLICE_TOL:
            raise AssertionError(f"{phase} {label}: per-iteration losses vs "
                                 f"the single-process steps {e:.3e}")
        f, b = check_launches(r, ROW_KERNEL, per_forward, n_calls, label,
                              phase)
        total[0] += f
        total[1] += b
        if any(gs != [GATHERS_PER_FORWARD] * n_calls for gs in r["gathers"]):
            raise AssertionError(f"{phase} {label}: gathers per model call "
                                 f"{r['gathers']}, want {GATHERS_PER_FORWARD}")
        losses = np.round(r["per_iter"], 5).tolist()
        log(phase, f"{label}: losses per step {losses}, vs the "
                   f"single-process steps {e:.3e} (tol "
                   f"{SLICE_TOL}); {GATHERS_PER_FORWARD} gathers in each of "
                   f"{n_calls} model calls per step; collectives "
                   f"{r['collectives']}; host seconds per step "
                   f"{np.round(r['seconds'], 4).tolist()}; peak device "
                   f"memory {r['peak_gib']:.2f} GiB")
    for r in ranks[1:]:
        if not np.array_equal(r["params"], ranks[0]["params"]):
            raise AssertionError(f"{phase}: rank {r['mesh']}'s parameters "
                                 "differ from rank (0, 0)'s")
    log(phase, f"parameters after the steps identical on all {len(ranks)} "
               f"ranks ({ranks[0]['params'].size} values)")
    return tuple(total)


def _check_grad_ranks(phase, ranks, grad_ref, mesh_label):
    """Each rank's fp32 step (`rank_grads`) against the single-process
    card step's: per-iteration losses and every gradient key (SLICE_TOL,
    `grads_close`)."""
    per_iter, grads, sums = grad_ref
    for r in ranks:
        e_iter = rel_err(r["per_iter"], per_iter)
        e_grad, key = grads_close(r["grads"], grads, sums, SLICE_TOL,
                                  f"{mesh_label} vs one process")
        if not e_iter <= SLICE_TOL:
            raise AssertionError(f"{phase} fp32 rank {r['mesh']}: "
                                 f"per-iteration losses {e_iter:.3e}")
        log(phase, f"fp32 batch {TRAIN_CHECK_BATCH} step (level 0 "
                   f"block-sparse fp32, {ELL_ROW_KERNEL}) on {mesh_label}, "
                   f"rank {r['mesh']}, vs one process on the card: "
                   f"per-iteration losses {e_iter:.3e}, reduced gradients "
                   f"worst {e_grad:.3e} ({key}); tol {SLICE_TOL} per key")


def node_tasks(device):
    """node16 (with its fp32 gradient check) and node64: 2-rank tasks."""
    return [
        (rank_train, {"device": str(device), "subdiv": SLICE_SUBDIV,
                      "n_data": 1, "n_node": 2,
                      "ar_iters": TRAIN_AR, "batch": BATCH,
                      "n_steps": NODE16_STEPS, "param_seed": SEED + 9}),
        (rank_grads, {"device": str(device), "subdiv": SLICE_SUBDIV,
                      "n_data": 1, "n_node": 2, "batch": TRAIN_CHECK_BATCH}),
        (rank_train, {"device": str(device), "subdiv": BIG_SUBDIV,
                      "n_data": 1, "n_node": 2,
                      "ar_iters": HP64_AR, "batch": HP64_BATCH,
                      "n_steps": NODE64_STEPS, "param_seed": SEED + 10,
                      "check_products": True})]


def check_node(device, card_line, train_ref, train64_ref, ranks):
    """node16's and node64's checks of their ranks' results."""
    node16 = [r[0] for r in ranks]
    k2 = {"node16": _check_rank_runs("node16", node16, train_ref,
                                     LAUNCHES_PER_FORWARD, TRAIN_AR + 1)}
    ms16 = 1e3 * min(max(r["seconds"][i] for r in node16)
                     for i in range(1, NODE16_STEPS))
    log("node16", f"HEALPix-{SLICE_SUBDIV} AR{TRAIN_AR} batch {BATCH} bf16 "
                  f"on 1 x 2: {ms16:.2f} ms per step (host clock, the "
                  f"slower rank, best step after the first; 2 ranks sharing "
                  f"one H100 over gloo: not a scaling number; {card_line})")
    grad_ref = single_grads(device, SLICE_SUBDIV, TRAIN_CHECK_BATCH)
    _check_grad_ranks("node16", [r[1] for r in ranks], grad_ref,
                      "1 data x 2 node ranks")
    node64 = [r[2] for r in ranks]
    k2["node64"] = _check_rank_runs("node64", node64, train64_ref,
                                    sum(PRODUCTS_PER_LEVEL), HP64_AR + 1)
    for r in node64:
        _log_products("node64", r["mesh"], r["products"])
    ms64 = 1e3 * max(r["seconds"][-1] for r in node64)
    log("node64", f"HEALPix-{BIG_SUBDIV} AR{HP64_AR} batch {HP64_BATCH} bf16 "
                  f"on 1 x 2: {ms64:.2f} ms for the last step (host clock, "
                  f"the slower rank; 2 ranks sharing one H100 over gloo: not "
                  f"a scaling number); peak device memory per rank "
                  f"{[round(r['peak_gib'], 2) for r in node64]} GiB "
                  f"({card_line})")
    return {"launches": k2, "ms16": ms16, "ms64": ms64,
            "peak64_gib": max(r["peak_gib"] for r in node64),
            "grad_ref": grad_ref, "shapes64": node64[0]["products"]["shapes"]}


def mesh16_tasks(device):
    """mesh16: the HEALPix-16 step on 2 data x 2 node ranks, and the fp32
    gradient check of node16 on the same mesh."""
    return [
        (rank_train, {"device": str(device), "subdiv": SLICE_SUBDIV,
                      "n_data": 2, "n_node": 2, "ar_iters": TRAIN_AR,
                      "batch": BATCH, "n_steps": MESH16_STEPS,
                      "param_seed": SEED + 9}),
        (rank_grads, {"device": str(device), "subdiv": SLICE_SUBDIV,
                      "n_data": 2, "n_node": 2, "batch": TRAIN_CHECK_BATCH})]


def check_mesh16(card_line, train_ref, grad_ref, ranks):
    """mesh16's checks of its ranks' results; its K2 launches."""
    launches = _check_rank_runs("mesh16", [r[0] for r in ranks], train_ref,
                                LAUNCHES_PER_FORWARD, TRAIN_AR + 1)
    _check_grad_ranks("mesh16", [r[1] for r in ranks], grad_ref,
                      "2 data x 2 node ranks")
    log("mesh16", f"HEALPix-{SLICE_SUBDIV} AR{TRAIN_AR} batch {BATCH} on 2 "
                  f"data x 2 node ranks: both groups reduce; 4 ranks sharing "
                  f"one H100 over gloo ({card_line})")
    return launches


# ---------------------------------------------------------------------------
# The whole mesh: members over ranks, BatchNorm statistics over the mesh,
# node-sharded grids (spawned ranks sharing the card)
# ---------------------------------------------------------------------------

def _counted_steps(model, step, n_steps, kernel=None):
    """n_steps of step(), counts from 0: per step the launches forward and
    backward (a forward hook on `model`, which also fires under
    torch.func's functional_call, reads the counters), the gathers of
    each model call, the host seconds and step()'s return; with `kernel`
    (a wrapper's name in ops.bcsr), the widths it launched at in each
    step."""
    import torch

    from deepsphere_weather_torch.ops import bcsr
    from deepsphere_weather_torch.parallel import (
        collective_counts,
        reset_collective_counts,
    )

    at_start, at_end, widths = [], [], []
    hooks = [model.register_forward_pre_hook(lambda *_: at_start.append(
                 collective_counts["all_gather"])),
             model.register_forward_hook(lambda *_: at_end.append(
                 (dict(bcsr.launch_counts),
                  collective_counts["all_gather"])))]
    fn = getattr(bcsr, kernel) if kernel else None

    def record(a, idx, x, *rest, **kw):
        widths[-1].append(x.shape[1])
        return fn(a, idx, x, *rest, **kw)

    if kernel:
        setattr(bcsr, kernel, record)
    torch.cuda.synchronize()
    bcsr.reset_launch_counts()
    reset_collective_counts()
    res = {"outs": [], "per_step": [], "gathers": [], "seconds": []}
    try:
        for _ in range(n_steps):
            before = dict(bcsr.launch_counts)
            at_start.clear()
            at_end.clear()
            widths.append([])
            t0 = time.perf_counter()
            res["outs"].append(step())
            torch.cuda.synchronize()
            res["seconds"].append(time.perf_counter() - t0)
            res["per_step"].append((
                {k: at_end[-1][0][k] - before[k] for k in before},
                {k: bcsr.launch_counts[k] - at_end[-1][0][k]
                 for k in before}))
            res["gathers"].append([e - s for s, (_, e)
                                   in zip(at_start, at_end)])
    finally:
        for h in hooks:
            h.remove()
        if kernel:
            setattr(bcsr, kernel, fn)
    res.update(launches=dict(bcsr.launch_counts),
               collectives=dict(collective_counts), widths=widths)
    return res


def _mesh_members(model):
    return [train_params(model, SEED + 60 + m) for m in range(MESH_MEMBERS)]


def rank_members(rank, device, n_data, n_node, n_member,
                 check_products=False, remat=False, steps=MESH_STEPS):
    """One rank of a member mesh (ensmesh16): this rank's members of the
    4-member flagship stack (`parallel.member_range`; rank 0's weights on
    every rank), MESH_STEPS member steps (`make_member_train_step(mesh)`:
    bf16, AR6, batch 16, its data and node shard of the batch), counts
    from 0. Returns every member's losses per step (gathered over the
    member group), the launches and gathers of each step, its level-0
    kernel's widths, its members' parameters after; with
    `check_products`, K2 at every (level, width) the step launched. With
    `remat`, `steps` member steps that recompute each AR iteration in the
    backward (remat16's mesh check)."""
    from deepsphere_weather_torch.engine import Adam, make_member_train_step
    from deepsphere_weather_torch.models import MemberStack, shard_geometry
    from deepsphere_weather_torch.parallel import (
        make_mesh,
        member_range,
        shard_batch,
    )
    from deepsphere_weather_torch.weights import broadcast_params

    mesh = make_mesh(n_data=n_data, n_node=n_node, n_member=n_member,
                     device=device)
    model = build_flagship(mesh.device, SLICE_SUBDIV).train()
    stack = MemberStack.from_states(model, _mesh_members(model))
    broadcast_params(stack, mesh)
    m0, m1 = member_range(MESH_MEMBERS, mesh)
    local = stack.select(m0, m1)
    del stack
    n = model.input_n_node
    model.geometry = shard_geometry(model.geometry, mesh)
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = shard_batch(train_batch(indexer, n, BATCH, mesh.device, SEED + 61),
                       mesh)
    opt = Adam(local.parameters(), lr=LR, member_axis=True)
    step = make_member_train_step(local, indexer, opt, TRAIN_AR + 1,
                                  mesh=mesh, remat=remat)
    res = _counted_steps(model, lambda: step(data, w, area_w), steps,
                         ROW_KERNEL if n_node > 1 else KERNEL)
    out = {"mesh": (mesh.data_rank, mesh.node_rank, mesh.member_rank),
           "members": (m0, m1),
           "per_iter": np.stack([p.float().cpu().numpy()
                                 for _, p in res.pop("outs")]),
           "params": {k: v.detach().float().cpu().numpy()
                      for k, v in local.named_parameters()}, **res}
    if check_products:
        out["products"] = check_sharded_products(
            model, lambda: step(data, w, area_w),
            lambda level: _laplacian(SLICE_SUBDIV >> level),
            f"HEALPix-{SLICE_SUBDIV} {m1 - m0}-member step")
    return out


def _rollout_stores(root):
    from deepsphere_weather_torch.data import (
        GlobalStandardScaler,
        SphericalDataset,
        StaticDataset,
    )

    dyn = SphericalDataset.open(os.path.join(
        root, "Data/dynamic/time_chunked/dynamic.zarr"))
    bc = SphericalDataset.open(os.path.join(
        root, "Data/bc/time_chunked/bc.zarr"))
    return {"data_dynamic": dyn, "data_bc": bc,
            "data_static": StaticDataset.open(os.path.join(
                root, "Data/static.zarr")),
            "scaler": GlobalStandardScaler().fit_dataset(dyn),
            "scaler_bc": GlobalStandardScaler().fit_dataset(bc)}


def ensemble_rollout(device, root, mesh=None):
    """`ensemble_rollout_predictions` of the 4 ensmesh16 members over the
    toy store at `root` (scaled space), from ENSMESH_T0S, with the K1
    launches and gathers it made."""
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.parallel import (
        collective_counts,
        reset_collective_counts,
    )
    from deepsphere_weather_torch.prob import ensemble_rollout_predictions
    from deepsphere_weather_torch.weights import stack_states

    model = build_flagship(device, SLICE_SUBDIV)
    stacked = stack_states(_mesh_members(model))
    reset_launch_counts()
    reset_collective_counts()
    preds = ensemble_rollout_predictions(
        model, stacked, **_rollout_stores(root), inverse_scale=False,
        indexer=ARIndexer.build(list(INPUT_K), [0], 1, ENSMESH_ROLL - 1),
        n_steps=ENSMESH_ROLL, t0s=np.asarray(ENSMESH_T0S),
        batch_size=len(ENSMESH_T0S), mesh=mesh)
    return {"preds": preds, "launches": dict(launch_counts),
            "gathers": collective_counts["all_gather"]}


def rank_rollout(rank, device, root):
    """The member-sharded ensemble rollout on a 1 x 1 x 2 mesh (the other
    ranks of the world idle)."""
    from deepsphere_weather_torch.parallel import make_mesh

    mesh = make_mesh(n_data=1, n_node=1, n_member=ENSMESH_ROLLOUT_MEMBERS,
                     device=device)
    if mesh is None:
        return None
    return {"mesh": mesh.member_rank,
            **ensemble_rollout(mesh.device, root, mesh)}


def _mesh_ms(ranks):
    """ms of the best step after the first, on the slower rank."""
    return 1e3 * min(max(r["seconds"][i] for r in ranks)
                     for i in range(1, len(ranks[0]["seconds"])))


def _check_member_ranks(phase, ranks, ref, kernel, label):
    """ensmesh16's checks of one member mesh's ranks (module docstring):
    losses, launches and gathers per step, parameters across the data
    and node ranks of each member. Returns (forward, backward) launches
    over the ranks."""
    total = [0, 0]
    sharded = kernel == ROW_KERNEL
    for r in ranks:
        where = f"{label} rank {r['mesh']} members {r['members']}"
        e = rel_err(r["per_iter"], ref[:len(r["per_iter"])])
        if not e <= SLICE_TOL:
            raise AssertionError(f"{phase} {where}: losses of every member "
                                 f"vs the single-process step {e:.3e}")
        f, b = check_launches(r, kernel, LAUNCHES_PER_FORWARD, TRAIN_AR + 1,
                              where, phase)
        total[0] += f
        total[1] += b
        want = GATHERS_PER_FORWARD if sharded else 0
        if any(gs != [want] * (TRAIN_AR + 1) for gs in r["gathers"]):
            raise AssertionError(f"{phase} {where}: gathers per model call "
                                 f"{r['gathers']}, want {want}")
        log(phase, f"{where}: losses of all {MESH_MEMBERS} members vs the "
                   f"single-process member step {e:.3e} (tol {SLICE_TOL}); "
                   f"{want} gathers in each model call (one a product, for "
                   f"both members); collectives {r['collectives']}; host "
                   f"seconds per step {np.round(r['seconds'], 3).tolist()}")
    first = {}
    for r in ranks:
        mine = first.setdefault(r["members"], r)
        for k, v in r["params"].items():
            if not np.array_equal(v, mine["params"][k]):
                raise AssertionError(f"{phase} {label}: members "
                                     f"{r['members']} differ between ranks "
                                     f"{mine['mesh']} and {r['mesh']} ({k})")
    log(phase, f"{label}: each member's parameters identical on all of its "
               f"data and node ranks ({len(ranks)} ranks)")
    return tuple(total)


def ensmesh16_refs(device, root):
    """ensmesh16's single-process references: the 4-member step's losses
    over MESH_STEPS steps, and the ensemble rollout of a toy store it
    writes to `root` (which the rollout ranks read)."""
    from deepsphere_weather_torch.data import generate_toy_data
    from deepsphere_weather_torch.engine import Adam, make_member_train_step
    from deepsphere_weather_torch.models import MemberStack

    model = build_flagship(device, SLICE_SUBDIV).train()
    stack = MemberStack.from_states(model, _mesh_members(model))
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, BATCH, device, SEED + 61)
    step = make_member_train_step(
        stack, indexer, Adam(stack.parameters(), lr=LR, member_axis=True),
        TRAIN_AR + 1)
    ref = np.stack([step(data, w, area_w)[1].float().cpu().numpy()
                    for _ in range(MESH_STEPS)])
    del stack, step
    generate_toy_data(root, sampling_kwargs={
        "subdivisions": SLICE_SUBDIV, "nest": True},
        n_timesteps=ENSMESH_STORE_STEPS, seed=SEED + 62)
    return ref, ensemble_rollout(device, root)


def ensmesh16_tasks(device, root):
    """ensmesh16's member meshes, its rollout on 1 x 1 x 2 and remat16's
    mesh check (the last a 4-rank task: the spawn ends with one)."""
    (d1, j1, m1), (d2, j2, m2) = ENSMESH
    return [
        (rank_members, {"device": str(device), "n_data": d1, "n_node": j1,
                        "n_member": m1, "check_products": True}),
        (rank_members, {"device": str(device), "n_data": d2, "n_node": j2,
                        "n_member": m2}),
        (rank_rollout, {"device": str(device), "root": root}),
        (rank_members, {"device": str(device), "n_data": d1, "n_node": j1,
                        "n_member": m1, "remat": True})]


def check_ensmesh16(card_line, ens_widths, ref, roll_ref, ranks):
    """ensmesh16's and remat16's mesh checks of their ranks' results
    (module docstring). `ens_widths`: ens16's K1 widths of one 2-member
    step, which each rank's 2 members must launch K2 at."""
    launches = {}
    node, data_ranks = [r[0] for r in ranks], [r[1] for r in ranks]
    launches["ensmesh16_1x2x2"] = _check_member_ranks(
        "ensmesh16", node, ref, ROW_KERNEL, "1 x 2 x 2")
    launches["ensmesh16_2x1x2"] = _check_member_ranks(
        "ensmesh16", data_ranks, ref, KERNEL, "2 x 1 x 2")
    launches["remat16_1x2x2"] = _check_remat_ranks([r[3] for r in ranks],
                                                   node, ref)
    for r in node:
        if any(ws != ens_widths for ws in r["widths"]):
            raise AssertionError(f"ensmesh16 rank {r['mesh']}: K2 widths "
                                 f"{r['widths']} vs ens16's 2-member K1 "
                                 f"widths {ens_widths}")
        _log_products("ensmesh16", r["mesh"], r["products"])
    log("ensmesh16", f"1 x 2 x 2: every rank's K2 launches at ens16's "
                     f"2-member widths {sorted(set(ens_widths))} (the "
                     f"members folded into one launch per product, K5 over "
                     f"K2)")
    roll = [r[2] for r in ranks if r[2] is not None]
    want_k1 = LAUNCHES_PER_FORWARD * ENSMESH_ROLL
    for r in roll:
        e = rel_err(r["preds"], roll_ref["preds"])
        if (r["preds"].shape != roll_ref["preds"].shape or not e <= BARS["bf16"]
                or r["launches"][KERNEL] != want_k1
                or sum(r["launches"].values()) != want_k1
                or r["gathers"] != 2):
            raise AssertionError(f"ensmesh16 rollout member rank "
                                 f"{r['mesh']}: {r['preds'].shape} vs "
                                 f"{roll_ref['preds'].shape}, {e:.3e}, "
                                 f"launches {r['launches']}, gathers "
                                 f"{r['gathers']}")
        log("ensmesh16", f"rollout on 1 x 1 x {ENSMESH_ROLLOUT_MEMBERS}, "
                         f"member rank {r['mesh']}: every member's "
                         f"{r['preds'].shape} vs the single process {e:.3e} "
                         f"(bar {BARS['bf16']:g}); {want_k1} {KERNEL} "
                         f"launches for its 2 members, 2 gathers")
    launches["ensmesh16_rollout"] = (sum(r["launches"][KERNEL]
                                         for r in roll), 0)
    ms = {"1x2x2": _mesh_ms(node), "2x1x2": _mesh_ms(data_ranks)}
    log("ensmesh16", f"{MESH_MEMBERS}-member step, HEALPix-{SLICE_SUBDIV} "
                     f"AR{TRAIN_AR} batch {BATCH} bf16: "
                     + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
                     + f" per step (host clock, the slower rank; 4 ranks "
                     f"sharing one H100 over gloo: not a scaling number; "
                     f"{card_line})")
    return {"launches": launches, "ms": ms}


def rank_bn(rank, device, n_data, n_node):
    """One rank of bn16's step on an n_data x n_node mesh: bn16's weights
    and batch, MESH_STEPS `with_norm_state` steps, counts from 0; the
    global losses, the running statistics after each step, the launches
    and gathers of each."""
    import torch

    from deepsphere_weather_torch.engine import make_train_step
    from deepsphere_weather_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(n_data=n_data, n_node=n_node, device=device)
    if mesh is None:          # idle in this task
        return None
    model, n = _sharded_model(mesh, SLICE_SUBDIV, SEED + 20, batch_norm=True)
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = shard_batch(train_batch(indexer, n, BATCH, mesh.device, SEED + 21),
                       mesh)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=ADAM_EPS)
    step = make_train_step(model, indexer, opt, TRAIN_AR + 1, mesh=mesh,
                           with_norm_state=True)
    stats = []

    def one():
        total, _ = step(data, w, area_w)
        stats.append({k: v.float().cpu().numpy().copy()
                      for k, v in model.norm_state().items()})
        return float(total)

    res = _counted_steps(model, one, MESH_STEPS)
    return {"mesh": (mesh.data_rank, mesh.node_rank),
            "losses": res.pop("outs"), "stats": stats, **res}


def bnmesh16_tasks(device):
    """bnmesh16's BatchNorm steps and fp32 gradient checks: 2-rank
    tasks."""
    tasks = []
    for n_data, n_node in BNMESH:
        tasks.append((rank_bn, {"device": str(device), "n_data": n_data,
                                "n_node": n_node}))
        tasks.append((rank_grads, {"device": str(device),
                                   "subdiv": SLICE_SUBDIV, "n_data": n_data,
                                   "n_node": n_node,
                                   "batch": TRAIN_CHECK_BATCH,
                                   "batch_norm": True}))
    return tasks


def check_bnmesh16(device, card_line, bn_ref, ranks):
    """bnmesh16's checks of its ranks' results (module docstring).
    `bn_ref`: bn16's losses and running statistics after each of its
    steps."""
    grad_ref = single_grads(device, SLICE_SUBDIV, TRAIN_CHECK_BATCH,
                            batch_norm=True)
    launches, ms = {}, {}
    for i, (n_data, n_node) in enumerate(BNMESH):
        label = f"{n_data} x {n_node}"
        runs = [r[2 * i] for r in ranks]
        kernel = ROW_KERNEL if n_node > 1 else KERNEL
        total = [0, 0]
        for r in runs:
            where = f"{label} rank {r['mesh']}"
            e_loss = rel_err(r["losses"], bn_ref["losses"][:MESH_STEPS])
            e_stats = max(rel_err(st[k], bn_ref["stats"][s][k])
                          for s, st in enumerate(r["stats"]) for k in st)
            if not (e_loss <= SLICE_TOL and e_stats <= SLICE_TOL):
                raise AssertionError(f"bnmesh16 {where}: losses {e_loss:.3e}"
                                     f", running statistics {e_stats:.3e} vs "
                                     "bn16's single-process steps")
            f, b = check_launches(r, kernel, LAUNCHES_PER_FORWARD,
                                  TRAIN_AR + 1, where, "bnmesh16")
            total[0] += f
            total[1] += b
            log("bnmesh16", f"{where}: losses {np.round(r['losses'], 5)} vs "
                            f"bn16's {e_loss:.3e}, running statistics after "
                            f"each step {e_stats:.3e} (tol {SLICE_TOL}); "
                            f"collectives {r['collectives']}")
        for r in runs[1:]:
            for s, st in enumerate(r["stats"]):
                for k, v in st.items():
                    if not np.array_equal(v, runs[0]["stats"][s][k]):
                        raise AssertionError(f"bnmesh16 {label}: running "
                                             f"{k} differs between ranks")
        log("bnmesh16", f"{label}: running statistics identical on every "
                        "rank after every step")
        launches[f"bnmesh16_{n_data}x{n_node}"] = (kernel, tuple(total))
        ms[label] = _mesh_ms(runs)
        _check_grad_ranks("bnmesh16", [r[2 * i + 1] for r in ranks],
                          grad_ref, f"{label} ranks, BatchNorm")
    log("bnmesh16", f"BatchNorm flagship AR{TRAIN_AR} batch {BATCH} bf16: "
                    + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
                    + f" per step (host clock, the slower rank; 2 ranks "
                    f"sharing one H100 over gloo: not a scaling number; "
                    f"{card_line})")
    return {"launches": launches, "ms": ms}


def grids_reference(device, name, index):
    """The single-process MESH_STEPS of one gridsnode400 configuration:
    the per-iteration losses of each, the whole model (for its level-0
    operator) and its Laplacian."""
    from deepsphere_weather_torch.engine import Adam, make_train_step

    cfg = _grids_config(name)
    model = grids_model(device, cfg, "bfloat16").train()
    model.load_state_dict(train_params(model, SEED + 70 + index))
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, BATCH, device,
                       SEED + 71 + index)
    opt = Adam(model.parameters(), lr=LR, eps=ADAM_EPS,
               gradient_clipping=cfg["training_settings"]["gradient_clipping"])
    step = make_train_step(model, indexer, opt, TRAIN_AR + 1)
    per_iter = np.stack([step(data, w, area_w)[1].float().cpu().numpy()
                         for _ in range(MESH_STEPS)])
    return per_iter, model, _grid_laplacian(cfg, model.geometry)


def rank_grid(rank, device, name, index):
    """One rank of a gridsnode400 configuration on 1 x 2: `grids_reference`'s
    steps on its node shard (its pools gathering over the node group),
    counts from 0; then K2 at every (level, width) the step launched."""
    from deepsphere_weather_torch.engine import Adam, make_train_step
    from deepsphere_weather_torch.models import shard_geometry
    from deepsphere_weather_torch.parallel import make_mesh, shard_batch
    from deepsphere_weather_torch.weights import broadcast_params

    mesh = make_mesh(n_data=1, n_node=2, device=device)
    if mesh is None:          # idle in this task
        return None
    cfg = _grids_config(name)
    model = grids_model(mesh.device, cfg, "bfloat16").train()
    model.load_state_dict(train_params(model, SEED + 70 + index))
    broadcast_params(model, mesh)
    n = model.input_n_node
    laplacian = _grid_laplacian(cfg, model.geometry)
    model.geometry = shard_geometry(model.geometry, mesh)
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = shard_batch(train_batch(indexer, n, BATCH, mesh.device,
                                   SEED + 71 + index), mesh)
    opt = Adam(model.parameters(), lr=LR, eps=ADAM_EPS,
               gradient_clipping=cfg["training_settings"]["gradient_clipping"])
    step = make_train_step(model, indexer, opt, TRAIN_AR + 1, mesh=mesh)
    res = _counted_steps(model, lambda: step(data, w, area_w)[1].float()
                         .cpu().numpy(), MESH_STEPS)
    out = {"mesh": (mesh.data_rank, mesh.node_rank),
           "per_iter": np.stack(res.pop("outs")),
           "pools": [type(p).__name__ for p in model.geometry.pools
                     + model.geometry.unpools],
           "params": torch_flat(model), **res}
    out["products"] = check_sharded_products(
        model, lambda: step(data, w, area_w), laplacian, name)
    return out


def torch_flat(model):
    import torch

    return torch.cat([p.detach().reshape(-1).float().cpu()
                      for p in model.parameters()]).numpy()


def image_conv_step(device, mesh=None):
    """One bf16 forward and backward of ConvNetSpherical with
    conv_type='image' at Equiangular_400km (36 x 72), seeded weights and
    input: the loss mean((y)^2) (on a node mesh this rank's share, summed
    over the node group), the gradients (reduced over the mesh) and the
    gathers of the forward."""
    import torch

    from deepsphere_weather_torch.engine import reduce_gradients
    from deepsphere_weather_torch.models import get_model, shard_geometry
    from deepsphere_weather_torch.parallel import (
        all_reduce_,
        collective_counts,
        node_range,
        reset_collective_counts,
    )
    from deepsphere_weather_torch.weights import broadcast_params

    n = 36 * 72
    model = get_model("ConvNetSpherical", tensor_info(n),
                      sampling="equiangular",
                      sampling_kwargs={"nlat": 36, "nlon": 72},
                      conv_type="image", numeric_precision="bfloat16",
                      device=device).train()
    model.load_state_dict(train_params(model, SEED + 75))
    x = torch.from_numpy(np.random.default_rng(SEED + 76).standard_normal(
        (BATCH, len(INPUT_K), n, F_STATIC + F_BC + F_DYN)).astype(
            np.float32)).to(device)
    if mesh is not None:
        broadcast_params(model, mesh)
        model.geometry = shard_geometry(model.geometry, mesh)
        x = x[:, :, slice(*node_range(n, mesh))].contiguous()
    reset_collective_counts()
    y = model(x)
    gathers = collective_counts["all_gather"]
    loss = (y.float() ** 2).sum() / (BATCH * n * F_DYN)
    loss.backward()
    reduce_gradients(model, mesh)
    loss = loss.detach()
    if mesh is not None:
        all_reduce_(loss, mesh.node_group)
    return {"loss": float(loss), "grads": grads_of(model),
            "finite": bool(torch.isfinite(y).all()), "gathers": gathers}


def rank_image(rank, device):
    from deepsphere_weather_torch.parallel import make_mesh

    mesh = make_mesh(n_data=1, n_node=2, device=device)
    if mesh is None:
        return None
    return {"mesh": (mesh.data_rank, mesh.node_rank),
            **image_conv_step(mesh.device, mesh)}


def gridsnode400_tasks(device):
    """gridsnode400's configurations and the image ConvNet on 1 x 2: 2-rank
    tasks."""
    return [(rank_grid, {"device": str(device), "name": name, "index": i})
            for i, name in enumerate(GRIDSNODE)] + [
        (rank_image, {"device": str(device)})]


def check_gridsnode400(device, card_line, refs, ranks):
    """gridsnode400's checks of its ranks' results (module docstring)
    against `refs` (`grids_reference` of each configuration). Returns K2's
    launches by path and the voronoi configuration's level-0 operator and
    Laplacian (for the transposed layout's kernel row)."""
    launches, voronoi = {}, None
    for i, name in enumerate(GRIDSNODE):
        ref, model, laplacian = refs[i]
        runs = [r[i] for r in ranks]
        total = [0, 0]
        want_gathers = GATHERS_PER_FORWARD + POOL_GATHERS
        for r in runs:
            where = f"{name} rank {r['mesh']}"
            e = rel_err(r["per_iter"], ref)
            if not e <= SLICE_TOL:
                raise AssertionError(f"gridsnode400 {where}: losses vs the "
                                     f"single-process steps {e:.3e}")
            f, b = check_launches(r, ROW_KERNEL, LAUNCHES_PER_FORWARD,
                                  TRAIN_AR + 1, where, "gridsnode400")
            total[0] += f
            total[1] += b
            if (set(r["pools"]) != {"ShardedPool", "ShardedUnpool"}
                    or any(gs != [want_gathers] * (TRAIN_AR + 1)
                           for gs in r["gathers"])):
                raise AssertionError(f"gridsnode400 {where}: pools "
                                     f"{r['pools']}, gathers {r['gathers']}")
            _log_products("gridsnode400", r["mesh"], r["products"])
            log("gridsnode400", f"{where}: losses vs one process {e:.3e} "
                                f"(tol {SLICE_TOL}); {want_gathers} gathers "
                                f"a model call ({GATHERS_PER_FORWARD} "
                                f"products, {POOL_GATHERS} pools and "
                                f"unpools); host seconds per step "
                                f"{np.round(r['seconds'], 3).tolist()}")
        if not np.array_equal(runs[0]["params"], runs[1]["params"]):
            raise AssertionError(f"gridsnode400 {name}: parameters differ "
                                 "between the ranks")
        launches[f"gridsnode400_{name}"] = tuple(total)
        log("gridsnode400", f"{name} AR{TRAIN_AR} batch {BATCH} bf16 on 1 x "
                            f"2: {_mesh_ms(runs):.2f} ms per step (the slower "
                            f"rank; 2 ranks sharing one H100 over gloo: not "
                            f"a scaling number); parameters identical on "
                            f"both ranks")
        if model.geometry.cheb_ops[0].bcsr.svals_t is not None:
            voronoi = (model.geometry.cheb_ops[0].bcsr, laplacian(0))
    one = image_conv_step(device)
    for r in (rr[-1] for rr in ranks):
        e_loss = rel_err(r["loss"], one["loss"])
        e_grad, key = grads_close(r["grads"], one["grads"], {}, SLICE_TOL,
                                  "image convolution on 1 x 2 vs one process")
        if not (r["finite"] and e_loss <= SLICE_TOL and r["gathers"] == 7):
            raise AssertionError(f"gridsnode400 image rank {r['mesh']}: "
                                 f"finite {r['finite']}, loss {e_loss:.3e}, "
                                 f"gathers {r['gathers']}")
        log("gridsnode400", f"ConvNetSpherical conv_type='image' at "
                            f"Equiangular_400km bf16 on 1 x 2, rank "
                            f"{r['mesh']}: forward and backward finite, 7 "
                            f"gathers (one a convolution), loss {e_loss:.3e} "
                            f"and gradients worst {e_grad:.3e} ({key}) vs one "
                            f"process (tol {SLICE_TOL})")
    return {"launches": launches, "voronoi": voronoi}


@clocked
def phase_meshes(device, card_line, train_ref, train64_ref, ens_widths,
                 bn_ref):
    """node16, node64, mesh16, bnmesh16, gridsnode400 and ensmesh16 (with
    remat16's mesh check) in one spawn of 4 ranks sharing the card: the
    single-process references the checks need from the card first, then
    every phase's tasks in turn, each on the ranks of its mesh (a 2-rank
    mesh leaves ranks 2 and 3 idle for that task), then each phase's
    checks (module docstring). `train_ref`, `train64_ref`: the
    single-process steps' per-iteration losses of train16 and train64;
    `ens_widths`: ens16's; `bn_ref`: bn16's. Returns each phase's
    readings."""
    root = tempfile.mkdtemp(prefix="dsw_ensmesh16_")
    try:
        ens_ref, roll_ref = ensmesh16_refs(device, root)
        grid_refs = [grids_reference(device, name, i)
                     for i, name in enumerate(GRIDSNODE)]
        phases = {"node": node_tasks(device), "mesh16": mesh16_tasks(device),
                  "bnmesh16": bnmesh16_tasks(device),
                  "gridsnode400": gridsnode400_tasks(device),
                  "ensmesh16": ensmesh16_tasks(device, root)}
        ranks = run_ranks(4, [t for tasks in phases.values() for t in tasks])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # each phase's results on the ranks its meshes use
    res, i = {}, 0
    for name, tasks in phases.items():
        part = [r[i:i + len(tasks)] for r in ranks]
        res[name] = [p for p in part if any(x is not None for x in p)]
        i += len(tasks)
    node = check_node(device, card_line, train_ref, train64_ref, res["node"])
    node["launches"]["mesh16"] = check_mesh16(card_line, train_ref,
                                              node["grad_ref"], res["mesh16"])
    return {"node": node,
            "ensmesh16": check_ensmesh16(card_line, ens_widths, ens_ref,
                                         roll_ref, res["ensmesh16"]),
            "bnmesh16": check_bnmesh16(device, card_line, bn_ref,
                                       res["bnmesh16"]),
            "gridsnode400": check_gridsnode400(device, card_line, grid_refs,
                                               res["gridsnode400"])}


def shard_rows_times(name, fn, plain, layout, L_rows, n, widths, device,
                     label, rng):
    """A row-range kernel (`fn`, its plain version `plain`) on one shard's
    layout against the full x [n, w] at each width: per-launch averages of
    its time (`device_ms`), its plain version's, cuSPARSE's on the CSR
    row slice `L_rows` against the full x and the bound; the largest max
    abs error vs the plain version (held to the bf16 bar: the tensor
    cores sum in another order)."""
    import torch
    import torch.nn.functional as F

    kind, a, idx, nz, r0, full_rows = layout
    csr = _csr(L_rows, device, torch.bfloat16)
    nnz, slots, x_blocks = _block_counts(
        KERNEL if kind == "super" else PLAIN_KERNEL, a, idx)
    acc = dict.fromkeys(("ms", "host_ms", "plain_ms", "library_ms",
                         "bound_ms", "bytes_ms", "ops_ms"), 0.0)
    err = 0.0
    for w in widths:
        x = torch.from_numpy(rng.standard_normal((n, w)).astype(
            np.float32)).to(device, torch.bfloat16)
        x_pad = F.pad(x, (0, (-w) % 128, 0, full_rows - n))
        args = (a, idx, x_pad, 0, a.shape[0])
        kw = {"nz": nz}
        y, want = fn(*args, **kw), plain(*args, **kw)
        e = float((y.float() - want.float()).abs().max())
        e_rel = rel_err(y.float().cpu(), want.float().cpu())
        if not e_rel < BARS["bf16"]:
            raise AssertionError(f"{name} {label} width {w}: vs plain "
                                 f"version max abs {e:.3e}, rel {e_rel:.3e}")
        err = max(err, e)
        t_bytes, t_ops = _bound(a, x, nnz, x_blocks,
                                out_rows=L_rows.shape[0])
        r = {"ms": device_ms(lambda: fn(*args, **kw)),
             "host_ms": host_ms(lambda: fn(*args, **kw)),
             "plain_ms": device_ms(lambda: plain(*args, **kw), n_iter=5),
             "library_ms": device_ms(lambda: torch.sparse.mm(csr, x)),
             "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
             "ops_ms": t_ops}
        log("times", f"{name} {label} rows of x[{n}, {w}]: {r['ms']:.4f} ms "
                     f"(host enqueue {r['host_ms']:.4f} ms, bound "
                     f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"cuSPARSE {r['library_ms']:.4f} ms), vs plain version "
                     f"max abs {e:.3e} rel {e_rel:.3e}, blocks {nnz}/{slots}, "
                     f"x blocks read {x_blocks}/{full_rows // 128}")
        for k in acc:
            acc[k] += r[k] / len(widths)
    acc["max_abs_err"] = err
    acc["bound_by"] = ("bytes" if acc["bytes_ms"] >= acc["ops_ms"]
                       else "operations")
    acc["widths"] = list(widths)
    return acc


def k2_new_shapes(device, voronoi, batch):
    """K2 at the shapes this round's phases gave it: HEALPix-16 level 0
    rows [0, n/2) at ensmesh16's 2-member folded widths, and the voronoi
    grids configuration's transposed layout (its backward) on rows
    [0, n/2) at the single step's widths (`shard_rows_times`)."""
    import torch

    from deepsphere_weather_torch.ops import BlockSparseOperator, bcsr

    fns = (bcsr.bcsr_super_spmm_rows, bcsr.bcsr_super_spmm_rows_reference)
    rng = np.random.default_rng(SEED + 77)
    L = _laplacian(SLICE_SUBDIV)
    n = L.shape[0]
    op = BlockSparseOperator.from_scipy(L, dtype=torch.bfloat16,
                                        device=device)
    widths = [batch * f for f in WIDTH_FEATURES]
    folded = [2 * (w + (-w) % 128) for w in widths]
    out = {"member_folded": shard_rows_times(
        ROW_KERNEL, *fns, op.row_shard(0, n // 2, group=None).fwd,
        L[:n // 2], n, folded, device,
        f"HEALPix-{SLICE_SUBDIV} level 0, 2 members folded", rng)}
    vop, vL = voronoi
    vn = vL.shape[0]
    out["voronoi_transposed"] = shard_rows_times(
        ROW_KERNEL, *fns, vop.row_shard(0, vn // 2, group=None).bwd,
        vL.T.tocsr()[:vn // 2], vn, widths, device,
        f"{GRIDSNODE[0]} level 0 transposed", rng)
    return out


def k2_node64_shapes(device, shapes, card_line):
    """K2 at each (level, width) shape of the node64 step (rank 0's rows
    [0, n/2) of the level's bf16 operator against the full x), beside its
    bound, plain version and cuSPARSE's CSR row slice
    (`shard_rows_times`). One entry per shape."""
    import torch

    from deepsphere_weather_torch.ops import BlockSparseOperator, bcsr

    fns = (bcsr.bcsr_super_spmm_rows, bcsr.bcsr_super_spmm_rows_reference)
    rng = np.random.default_rng(SEED + 78)
    out, ops = [], {}
    for level, width in shapes:
        L = _laplacian(BIG_SUBDIV >> level)
        n = L.shape[0]
        if level not in ops:
            ops[level] = BlockSparseOperator.from_scipy(
                L, dtype=torch.bfloat16, device=device).row_shard(
                    0, n // 2, group=None)
        r = shard_rows_times(ROW_KERNEL, *fns, ops[level].fwd, L[:n // 2], n,
                             [width], device,
                             f"HEALPix-{BIG_SUBDIV} level {level} node64 "
                             f"rows [0, {n // 2})", rng)
        out.append({"level": level, "width": width, **{
            k: r[k] for k in ("ms", "host_ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by", "max_abs_err")}})
    log("times", f"{ROW_KERNEL} over the node64 step's {len(out)} shapes, "
                 f"one launch each: {sum(r['ms'] for r in out):.4f} ms, "
                 f"cuSPARSE row slices {sum(r['library_ms'] for r in out):.4f}"
                 f" ms, bound {sum(r['bound_ms'] for r in out):.4f} ms "
                 f"({card_line})")
    return out


# ---------------------------------------------------------------------------
# The train -> predict -> verify protocol through the port's CLI
# ---------------------------------------------------------------------------

def _instrument_protocol():
    """Wrap the driver's step factories, the rollout and the stages of
    `cli.train_predict.main` (module attributes they are called through)
    to record, per part, the K1 launches (training forward and backward,
    validation, prediction), which step factories the trainer took, and
    each stage's wall time. Returns (record, undo)."""
    import torch

    import deepsphere_weather_torch.data.zarrstore as zarrstore
    import deepsphere_weather_torch.engine as engine
    import deepsphere_weather_torch.engine.prediction as prediction
    import deepsphere_weather_torch.engine.training as training
    import deepsphere_weather_torch.verif as verif
    from deepsphere_weather_torch.ops.bcsr import launch_counts

    rec = {"cached_steps": 0, "streaming_steps": 0, "train_forward": 0,
           "train_backward": 0, "validation": 0, "predict": 0,
           "seconds": {}, "models": [], "chunk_writes": 0,
           "chunk_write_s": 0.0, "writes_at": {}, "train_steps": 0}
    saved = []

    def k1():
        return launch_counts[KERNEL]

    def patch(module, name, new):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    def hook(model):
        if any(m is model for m in rec["models"]):
            return
        rec["models"].append(model)
        at = [0]
        model.register_forward_pre_hook(lambda *_: at.__setitem__(0, k1()))

        def after(*_):
            if torch.is_grad_enabled():
                rec["train_forward"] += k1() - at[0]
        model.register_forward_hook(after)

    def counted(fn, part, kind=None):
        def make(model, *args, **kw):
            hook(model)
            if kind:
                rec[kind] += 1
            made = fn(model, *args, **kw)
            step, rest = (made[0], made[1:]) if isinstance(made, tuple) \
                else (made, None)

            def run(*a, **k):
                c, f = k1(), rec["train_forward"]
                out = step(*a, **k)
                if part == "train":
                    rec["train_steps"] += 1
                    rec["train_backward"] += (k1() - c) - (
                        rec["train_forward"] - f)
                else:
                    rec[part] += k1() - c
                return out
            return (run,) + rest if rest is not None else run
        return make

    def timed(module, name, stage):
        fn = getattr(module, name)

        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec["seconds"][stage] = time.perf_counter() - t0
            rec["writes_at"][stage] = (rec["chunk_writes"],
                                       rec["chunk_write_s"])
            return out
        patch(module, name, run)

    patch(training, "make_cached_train_step", counted(
        training.make_cached_train_step, "train", "cached_steps"))
    patch(training, "make_train_step", counted(
        training.make_train_step, "train", "streaming_steps"))
    patch(training, "make_cached_validation_fn", counted(
        training.make_cached_validation_fn, "validation"))
    patch(training, "make_validation_fn", counted(
        training.make_validation_fn, "validation"))
    patch(prediction, "make_rollout_block", counted(
        prediction.make_rollout_block, "predict"))
    write_chunk = zarrstore.ZarrArray._write_chunk

    def counted_write(self, idx, data):
        t0 = time.perf_counter()
        write_chunk(self, idx, data)
        rec["chunk_writes"] += 1
        rec["chunk_write_s"] += time.perf_counter() - t0
    patch(zarrstore.ZarrArray, "_write_chunk", counted_write)
    timed(engine, "AutoregressiveTraining", "train")
    timed(engine, "AutoregressivePredictions", "predict")
    timed(engine, "rechunk_forecasts_for_verification", "rechunk")
    timed(verif, "deterministic", "verify")

    def undo():
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)
    return rec, undo


def _bare_step_ms(model, n_ar, batch, n_static, n_bc):
    """ms per bare train step of the trained model at the driver's last AR
    depth and batch, on one device-resident synthetic batch (no loader,
    no window gather): windows of SMOKE_STEPS steps, best of
    SMOKE_WINDOWS."""
    import torch

    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine import make_train_step

    indexer = ARIndexer.build(list(PROTOCOL_INPUT_K), [0], PROTOCOL_CYCLE,
                              n_ar)
    dev = next(model.parameters()).device
    rng = np.random.default_rng(SEED + 20)
    W, V = indexer.window_size, model.input_n_node
    data = {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev) for k, shape in (
        ("dynamic", (batch, W, V, F_DYN)), ("bc", (batch, W, V, n_bc)),
        ("static", (V, n_static)))}
    opt = torch.optim.Adam(model.parameters(), lr=1e-5, eps=ADAM_EPS)
    step = make_train_step(model, indexer, opt, n_ar + 1)
    w = np.ones(n_ar + 1, np.float32)
    step(data, w)
    best = float("inf")
    for _ in range(SMOKE_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SMOKE_STEPS):
            step(data, w)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / SMOKE_STEPS)
    return 1e3 * best


@clocked
def phase_protocol(device, card_line, bare_ar6_ms, prep):
    """protocol16: the flagship config (bf16, full width and depth)
    trained, forecast AR20 and verified through the port's CLI entry point
    (`cli.train_predict.main`) on prep16's toy HEALPix-16 data and its
    generated config; then one --resume epoch. Returns K1's launches by
    part and, for serve16, the temporary directory (prep16's; the caller
    removes it), the data directory, the resumed experiment and a copy of
    the experiment from before the resume."""
    import shutil

    import torch

    from deepsphere_weather_torch.cli.train_predict import main as train_main
    from deepsphere_weather_torch.engine.prediction import ForecastDataset
    from deepsphere_weather_torch.native import bloscio
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    root = prep["root"]
    try:
        t_data = prep["seconds"]["prepare_toy_data"]
        with open(prep["config"]) as f:
            cfg = json.load(f)
        shipped = {k: cfg["training_settings"][k]
                   for k in ("numeric_precision", "epochs")}
        cfg["training_settings"].update(numeric_precision="bfloat16",
                                        epochs=PROTOCOL_EPOCHS)
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        log("protocol16", f"{PROTOCOL_CONFIG}, cut: numeric_precision "
                          f"{shipped['numeric_precision']} -> bfloat16, "
                          f"epochs {shipped['epochs']} -> {PROTOCOL_EPOCHS}; "
                          "full width and depth, num_workers as shipped; "
                          f"prep16's config and toy HEALPix-{SLICE_SUBDIV} "
                          f"data, 1460 six-hour steps, seed {SEED} "
                          f"({t_data:.1f} s)")

        rec, undo = _instrument_protocol()
        try:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            exp, gs = train_main(cfg_path, os.path.join(root, "data"),
                                 os.path.join(root, "exp"), force=True,
                                 ar_iterations_prediction=PROTOCOL_AR_PREDICT,
                                 device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(launch_counts)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            undo()
            torch.use_deterministic_algorithms(False)
        parts = {k: rec[k] for k in ("train_forward", "train_backward",
                                     "validation", "predict")}
        # the checks
        if rec["cached_steps"] == 0 or rec["streaming_steps"]:
            raise AssertionError(f"the trainer took the streaming loader "
                                 f"({rec['cached_steps']} device-cache step "
                                 f"factories, {rec['streaming_steps']} "
                                 "streaming)")
        for part, n in parts.items():
            if n <= 0:
                raise AssertionError(f"no {KERNEL} launch in {part}: "
                                     f"{parts}")
        if (launches[KERNEL] != sum(parts.values())
                or sum(launches.values()) != launches[KERNEL]):
            raise AssertionError(f"launches {launches} are not the parts' "
                                 f"{parts}")
        with open(os.path.join(exp, "training_info",
                               "ar_training_info.json")) as f:
            info = json.load(f)
        losses = info["training_total_loss"] + info["validation_total_loss"]
        if not losses or not np.isfinite(losses).all():
            raise AssertionError(f"logged losses not finite: {losses}")
        for rel_path in ("model_weights/model.npz", "training_info/state.json",
                         "model_skills/deterministic_global_skill.npz"):
            if not os.path.exists(os.path.join(exp, rel_path)):
                raise AssertionError(f"{rel_path} missing from {exp}")
        fc = ForecastDataset.open(os.path.join(
            exp, "model_predictions", "forecast_chunked",
            "test_forecasts.zarr"))
        arr = np.stack([fc.variables[n][...] for n in fc.feature_order], -1)
        want = (fc.n_frt, PROTOCOL_AR_PREDICT + 1, 12 * SLICE_SUBDIV ** 2,
                F_DYN)
        if arr.shape != want or not np.isfinite(arr).all():
            raise AssertionError(f"forecast store {arr.shape}, want {want} "
                                 "finite")
        rmse = np.asarray(gs["RMSE"])
        if not (rmse[PROTOCOL_AR_PREDICT] > rmse[1]).all():
            raise AssertionError(f"RMSE does not grow from lead 1 to lead "
                                 f"{PROTOCOL_AR_PREDICT}: {rmse[1]} -> "
                                 f"{rmse[PROTOCOL_AR_PREDICT]}")
        secs = rec["seconds"]
        sps = info["samples_per_sec"]
        driver_sps = float(np.median(sps[1:] if len(sps) > 1 else sps))
        with open(os.path.join(exp, "training_info", "state.json")) as f:
            n_ar = len(json.load(f)["ar_scheduler"]["absolute_weights"]) - 1
        batch = cfg["training_settings"]["training_batch_size"]
        bare_ms = _bare_step_ms(rec["models"][0], n_ar, batch, F_STATIC,
                                F_BC)
        log("protocol16", f"trained {rec['train_steps']} updates (scored "
                          f"every {cfg['training_settings']['scoring_interval']}) "
                          f"over {len(info['epoch_boundaries'])} epochs (AR "
                          f"{n_ar} at the end, growth at updates "
                          f"{info['ar_growth_events']}), losses finite: "
                          f"train {info['training_total_loss'][0]:.5f} -> "
                          f"{info['training_total_loss'][-1]:.5f}, val "
                          f"{info['validation_total_loss'][0]:.5f} -> "
                          f"{info['validation_total_loss'][-1]:.5f}; "
                          f"device-cache path ({rec['cached_steps']} step "
                          "factories, no streaming one)")
        log("protocol16", f"forecast store {arr.shape} finite; RMSE lead 1 "
                          f"{np.round(rmse[1], 4).tolist()} -> lead "
                          f"{PROTOCOL_AR_PREDICT} "
                          f"{np.round(rmse[PROTOCOL_AR_PREDICT], 4).tolist()} "
                          f"({fc.feature_order})")
        log("protocol16", f"wall seconds: data {t_data:.1f}, main "
                          f"{wall:.1f} (train {secs['train']:.1f}, predict "
                          f"{secs['predict']:.1f}, rechunk "
                          f"{secs['rechunk']:.1f}, verify "
                          f"{secs['verify']:.1f}); AR{PROTOCOL_AR_PREDICT} "
                          f"forecast {secs['predict'] / fc.n_frt:.4f} s per "
                          f"reference time ({fc.n_frt}); peak device memory "
                          f"{peak_gib:.2f} GiB ({card_line})")
        (n_p, s_p), (n_r, s_r) = (rec["writes_at"]["predict"],
                                  rec["writes_at"]["rechunk"])
        log("protocol16", f"zarr chunk writes (host, zlib or blosc): predict "
                          f"{n_p} in {s_p:.1f} s on its writer thread, "
                          f"rechunk {n_r - n_p} in {s_r - s_p:.1f} s")
        log("protocol16", f"training samples/s: driver {driver_sps:.2f} "
                          f"(median of {len(sps)} scoring intervals, "
                          f"validation excluded), bare step at AR{n_ar} "
                          f"batch {batch} {1e3 * batch / bare_ms:.2f} "
                          f"({bare_ms:.2f} ms), bare AR{TRAIN_AR} step of "
                          f"phase train {1e3 * BATCH / bare_ar6_ms:.2f} "
                          f"({bare_ar6_ms:.2f} ms) ({card_line})")
        log("protocol16", f"{KERNEL} launches: {parts} = "
                          f"{launches[KERNEL]}, no other kernel")
        with open(os.path.join(exp, "model_skills", "verify_stats.json")) as f:
            log("protocol16", f"verify_stats {json.load(f)}; libblosc "
                              f"{'loads' if bloscio.available() else 'absent'}"
                              " on this machine")

        # serve16's first member: the experiment before the resume
        member0 = os.path.join(root, "member0", os.path.basename(exp))
        shutil.copytree(exp, member0)
        # one --resume epoch from the checkpoint just written
        cfg["training_settings"]["epochs"] = 1
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(exp, "model_weights", "model.npz"), "rb") as f:
            weights = f.read()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            exp2, gs2 = train_main(cfg_path, os.path.join(root, "data"),
                                   os.path.join(root, "exp"), resume=True,
                                   ar_iterations_prediction=2, device=device,
                                   verbose=False)
        finally:
            torch.use_deterministic_algorithms(False)
        resumed = dict(launch_counts)
        with open(os.path.join(exp2, "training_info",
                               "ar_training_info.json")) as f:
            info2 = json.load(f)
        with open(os.path.join(exp2, "model_weights", "model.npz"), "rb") as f:
            changed = f.read() != weights
        if (len(info2["epoch_boundaries"]) != 1 or not info2["iterations"]
                or not changed or not np.isfinite(np.asarray(gs2["RMSE"])).all()
                or resumed[KERNEL] == 0):
            raise AssertionError(f"--resume did not train one more epoch: "
                                 f"epochs {info2['epoch_boundaries']}, "
                                 f"{len(info2['iterations'])} updates, "
                                 f"weights changed {changed}, launches "
                                 f"{resumed}")
        log("protocol16", f"--resume: loaded the checkpoint, one more epoch "
                          f"(scored to update {info2['iterations'][-1]}, weights "
                          f"changed), AR2 forecast finite, "
                          f"{resumed[KERNEL]} {KERNEL} launches, "
                          f"{time.perf_counter() - t0:.1f} s")
        return {"forward": parts["train_forward"] + parts["validation"]
                + parts["predict"], "backward": parts["train_backward"],
                "parts": parts, "root": root,
                "data": os.path.join(root, "data"), "exp": str(exp2),
                "member0": member0}
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


# ---------------------------------------------------------------------------
# serve16: serving protocol16's flagship from artifacts
# ---------------------------------------------------------------------------

class _RefuseGeometry:
    """Within the block, building a geometry raises: an artifact must load
    and run without the model or its geometry."""

    def __enter__(self):
        import deepsphere_weather_torch.models.geometry as geometry
        import deepsphere_weather_torch.models.unet as unet
        import deepsphere_weather_torch.models.variants as variants

        def refuse(*a, **k):
            raise AssertionError("loading an artifact built a geometry")
        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (geometry, "build_model_geometry"),
            (geometry, "cached_graph_laplacian"),
            (unet, "build_model_geometry"),
            (variants, "build_model_geometry"))]
        for m, n, _ in self.saved:
            setattr(m, n, refuse)

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def record_widths(fn, wrapper="bcsr_super_spmm"):
    """Run fn() and return the widths of x at the launches of `wrapper`
    in `ops.bcsr` (K1's by default), in order (the registered ops call
    the module's wrappers by name, x third)."""
    from deepsphere_weather_torch.ops import bcsr

    widths, kernel = [], getattr(bcsr, wrapper)

    def record(*args):
        widths.append(args[2].shape[1])
        return kernel(*args)
    setattr(bcsr, wrapper, record)
    try:
        fn()
    finally:
        setattr(bcsr, wrapper, kernel)
    return widths


def _serve_inputs(data, meta, batch, n_steps, seed):
    """Physical-unit histories [batch, H, V, F] and boundary conditions
    [batch, n_steps, n_input_k, V, F_bc] at seeded reference positions of
    the toy stores."""
    from deepsphere_weather_torch.cli.common import open_datasets

    dyn, bc, _ = open_datasets(data)
    H, fc = meta["history_size"], meta["forecast_cycle"]
    in_k = np.asarray(meta["input_k"])
    rng = np.random.default_rng(seed)
    t0s = rng.integers(H, dyn.n_time - n_steps * fc, size=batch)
    hist = np.stack([dyn.read_stacked(np.arange(t - H + 1, t + 1))
                     for t in t0s])
    bcs = np.stack([np.stack([bc.read_stacked(t + s * fc + in_k)
                              for s in range(n_steps)]) for t in t0s])
    return hist.astype(np.float32), bcs.astype(np.float32)


@clocked
def phase_serve16(device, card_line, proto):
    """serve16: protocol16's trained flagship (bf16, full width and depth)
    served from artifacts on disk: `cli.predict` on the resumed
    experiment, `cli.export_model` of one member and of both, the
    artifacts loaded with the geometry builder refused, the service, the
    2-member ensemble through K5's rule, and the HTTP server. Returns the
    launches and readings."""
    import io
    import urllib.request

    import torch

    from deepsphere_weather_torch.cli.common import (
        load_experiment_model,
        open_datasets,
    )
    from deepsphere_weather_torch.cli.export_model import main as export_main
    from deepsphere_weather_torch.cli.predict import main as predict_main
    from deepsphere_weather_torch.cli.serve import serve
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine.prediction import ForecastDataset
    from deepsphere_weather_torch.engine.step import make_rollout_block
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.serve import ForecastService

    data, exp, member0 = proto["data"], proto["exp"], proto["member0"]
    out = os.path.join(proto["root"], "serve16")
    bar = BARS["bf16"]
    t_phase = time.perf_counter()

    # cli.predict: AR20 from reference times of the resumed experiment's
    # own forecast store (written by its --resume run, same weights)
    store = ForecastDataset.open(os.path.join(
        exp, "model_predictions", "forecast_chunked", "test_forecasts.zarr"))
    # (from the first third: the AR20 rollout stays inside the BC store)
    pick = np.linspace(0, store.n_frt // 3, SERVE_FRTS).astype(int)
    reset_launch_counts()
    t0 = time.perf_counter()
    fc = predict_main(exp, data, forecast_reference_times=[
        str(t) for t in store.forecast_reference_time[pick]],
        ar_iterations=PROTOCOL_AR_PREDICT,
        out_path=os.path.join(out, "long_forecasts.zarr"), verbose=False,
        device=device)
    t_predict = time.perf_counter() - t0
    predict_launches = launch_counts[KERNEL]
    arr = np.stack([fc.variables[n][...] for n in fc.feature_order], -1)
    want = (SERVE_FRTS, PROTOCOL_AR_PREDICT + 1, 12 * SLICE_SUBDIV ** 2,
            F_DYN)
    if arr.shape != want or not np.isfinite(arr).all():
        raise AssertionError(f"cli.predict store {arr.shape}, want {want} "
                             "finite")
    lead1 = {n: rel_err(fc.variables[n][:, 1, :],
                        store.variables[n][...][pick, 1, :])
             for n in fc.feature_order}
    if not max(lead1.values()) <= bar:
        raise AssertionError(f"cli.predict lead 1 vs the experiment's store "
                             f"{lead1} (bar {bar})")
    if (predict_launches != LAUNCHES_PER_FORWARD * (PROTOCOL_AR_PREDICT + 1)
            or sum(launch_counts.values()) != predict_launches):
        raise AssertionError(f"cli.predict launched {dict(launch_counts)}")
    log("serve16", f"cli.predict AR{PROTOCOL_AR_PREDICT} of {SERVE_FRTS} "
                   f"reference times: {arr.shape} finite, lead 1 vs the "
                   f"experiment's store {lead1} (bar {bar}), "
                   f"{predict_launches} {KERNEL} launches, {t_predict:.2f} s")

    # cli.export_model: each member alone, and both stacked
    dirs = {"single": os.path.join(out, "single"),
            "single0": os.path.join(out, "single0"),
            "ensemble": os.path.join(out, "ensemble")}
    kw = dict(batch_size=BATCH, block_size=BLOCK, verbose=False,
              device=device)
    secs = {}
    for name, src, members in (("single", exp, None),
                               ("single0", member0, None),
                               ("ensemble", exp, [member0, exp])):
        t0 = time.perf_counter()
        export_main(src, data, out=dirs[name], member_dirs=members, **kw)
        secs[f"export_{name}"] = time.perf_counter() - t0
    mb = {k: os.path.getsize(os.path.join(d, "rollout.pt2")) / 1e6
          for k, d in dirs.items()}
    with _RefuseGeometry():
        svcs = {}
        for name, d in dirs.items():
            t0 = time.perf_counter()
            svcs[name] = ForecastService.from_dir(d)
            secs[f"load_{name}"] = time.perf_counter() - t0
        server, http_svc = serve(dirs["single"], port=0, block=False)
    svc, ens = svcs["single"], svcs["ensemble"]
    log("serve16", f"exported and loaded (geometry builder refused): "
                   + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
                   + "; rollout.pt2 " + ", ".join(
                       f"{k} {v:.1f} MB" for k, v in mb.items()))

    try:
        meta = svc.meta
        hist, bc = _serve_inputs(data, meta, BATCH, N_STEPS, SEED + 20)
        forwards = {k: count_forwards(s.rollout) for k, s in svcs.items()}
        first = {k: svcs[k].predict(hist, BLOCK, bc[:, :BLOCK])
                 for k in ("single", "single0")}              # warm-up
        # in-process rollout of the same weights, first block (scaled)
        datasets = open_datasets(data)
        _, model = load_experiment_model(exp, datasets, device)
        rollout, _ = make_rollout_block(model, ARIndexer.build(
            meta["input_k"], meta["output_k"], meta["forecast_cycle"], 1),
            BLOCK)
        bc0 = bc[:, :BLOCK]
        if svc.scaler_bc is not None:
            bc0 = svc.scaler_bc.transform(bc0)
        with torch.inference_mode():
            _, _, ref = rollout(
                torch.from_numpy(svc.scaler.transform(hist).astype(
                    np.float32)).to(device), None,
                torch.from_numpy(bc0.astype(np.float32)).to(device),
                torch.from_numpy(datasets[2].read_stacked()).to(device))
        e_inproc = rel_err(svc.scaler.transform(first["single"]),
                           ref.float().cpu().numpy())
        if not e_inproc <= bar:
            raise AssertionError(f"artifact vs in-process rollout "
                                 f"{e_inproc:.3e} > {bar}")
        widths = {}
        launches = {}
        figs = {}
        for name in ("single", "ensemble"):
            s = svcs[name]
            widths[name] = record_widths(
                lambda s=s: s.predict(hist, BLOCK, bc[:, :BLOCK]))
            reset_launch_counts()
            forwards[name][0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = s.predict(hist, N_STEPS, bc)
            torch.cuda.synchronize()
            figs[f"{name}_step_ms"] = 1e3 * (time.perf_counter() - t0) / N_STEPS
            launches[name] = (launch_counts[KERNEL], forwards[name][0])
            if (launch_counts[KERNEL] != LAUNCHES_PER_FORWARD
                    * forwards[name][0] or forwards[name][0] == 0
                    or sum(launch_counts.values()) != launch_counts[KERNEL]):
                raise AssertionError(
                    f"{name}: {dict(launch_counts)} launches for "
                    f"{forwards[name][0]} forwards; want "
                    f"{LAUNCHES_PER_FORWARD} {KERNEL} each, nothing else")
            members = (2,) if name == "ensemble" else ()
            if (res.shape != members + (BATCH, N_STEPS, 1, meta["n_node"],
                                        F_DYN) or not np.isfinite(res).all()):
                raise AssertionError(f"{name} forecast {res.shape} is not "
                                     "finite of the right shape")
            figs[name] = res
        if widths["ensemble"] != [2 * w for w in widths["single"]]:
            raise AssertionError(f"ensemble widths {widths['ensemble']} are "
                                 f"not twice the single's {widths['single']}")
        # each member against its own single artifact, step by step over
        # the first block. The member-stacked program runs the dense GEMMs
        # as batched ones (other cuBLAS kernels, other roundings in bf16),
        # and the feedback grows their difference step by step: the bf16
        # bar holds for the first step, one forward; the block's are
        # recorded
        e_steps = [[rel_err(svc.scaler.transform(figs["ensemble"][i][:, j]),
                            svc.scaler.transform(first[k][:, j]))
                    for j in range(BLOCK)]
                   for i, k in enumerate(("single0", "single"))]
        if not max(e[0] for e in e_steps) <= bar:
            raise AssertionError(f"ensemble members vs their single artifacts "
                                 f"at the first step {[e[0] for e in e_steps]}"
                                 f" (bar {bar}; by step {e_steps})")
        summary = ForecastService.summarize(figs["ensemble"])
        if not all(np.isfinite(v).all() for v in summary.values()):
            raise AssertionError("ensemble summary not finite")

        # 5 concurrent single-sample requests
        t0 = time.perf_counter()
        futs = [None] * N_SUBMIT
        threads = [threading.Thread(target=lambda i=i: futs.__setitem__(
            i, svc.submit(hist[i], n_steps=BLOCK, bc=bc[i, :BLOCK])))
            for i in range(N_SUBMIT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        answers = [f.result(timeout=600) for f in futs]
        t_submit = time.perf_counter() - t0
        e_submit = max(rel_err(svc.scaler.transform(a),
                               svc.scaler.transform(first["single"][i]))
                       for i, a in enumerate(answers))
        if not e_submit <= bar:
            raise AssertionError(f"submit answers vs predict {e_submit:.3e}")

        # HTTP
        base = f"http://127.0.0.1:{server.server_port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                raise AssertionError("/healthz")
        with urllib.request.urlopen(base + "/v1/meta", timeout=60) as r:
            if json.loads(r.read()) != meta:
                raise AssertionError("/v1/meta differs from the artifact's")
        buf = io.BytesIO()
        np.savez(buf, history=hist, bc=bc[:, :BLOCK])
        t0 = time.perf_counter()
        req = urllib.request.Request(base + f"/v1/predict?n_steps={BLOCK}",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            got = np.load(io.BytesIO(r.read()))["forecast"]
        t_http = time.perf_counter() - t0
        e_http = rel_err(svc.scaler.transform(got),
                         svc.scaler.transform(first["single"]))
        if not e_http <= HTTP_TOL:
            raise AssertionError(f"HTTP forecast vs svc.predict {e_http:.3e}"
                                 f" > {HTTP_TOL}")
    finally:
        server.shutdown()
        server.server_close()
        http_svc.close()
        for s in svcs.values():
            s.close()

    per_fwd = widths["single"][:LAUNCHES_PER_FORWARD]
    log("serve16", f"single artifact: in-process rollout {e_inproc:.3e}, "
                   f"{launches['single'][0]} {KERNEL} launches for "
                   f"{launches['single'][1]} forwards, widths per forward "
                   f"{per_fwd}; {N_SUBMIT} submits vs predict {e_submit:.3e}")
    log("serve16", f"2-member artifact: {launches['ensemble'][0]} {KERNEL} "
                   f"launches for {launches['ensemble'][1]} forwards "
                   f"({LAUNCHES_PER_FORWARD} per forward for both members, "
                   f"K5's rule), widths per forward "
                   f"{widths['ensemble'][:LAUNCHES_PER_FORWARD]}; members vs "
                   f"their single artifacts, steps 1-{BLOCK}: "
                   f"{np.round(e_steps, 6).tolist()} (bar {bar} at step 1); "
                   "summary finite")
    log("serve16", f"HTTP /healthz, /v1/meta, POST vs svc.predict "
                   f"{e_http:.3e} (bar {HTTP_TOL})")
    log("serve16", f"times ({card_line}): export single "
                   f"{secs['export_single']:.2f} s, ensemble "
                   f"{secs['export_ensemble']:.2f} s; load single "
                   f"{secs['load_single']:.2f} s, ensemble "
                   f"{secs['load_ensemble']:.2f} s; rollout.pt2 single "
                   f"{mb['single']:.1f} MB, ensemble {mb['ensemble']:.1f} MB; "
                   f"forecast step (batch {BATCH}, {N_STEPS} steps) single "
                   f"{figs['single_step_ms']:.2f} ms, 2-member "
                   f"{figs['ensemble_step_ms']:.2f} ms; {N_SUBMIT} submits "
                   f"{1e3 * t_submit:.1f} ms; HTTP round trip (batch {BATCH},"
                   f" {BLOCK} steps) {1e3 * t_http:.1f} ms; phase "
                   f"{time.perf_counter() - t_phase:.1f} s")
    k5 = k5_vmap_times(model.geometry.cheb_ops[0].bcsr, per_fwd, device)
    log("serve16", f"K5 over one forward's {len(per_fwd)} products, 2 "
                   f"members: vmapped vs member loop max abs "
                   f"{k5['max_abs_err']:.3e}; one K1 launch at twice the "
                   f"width {k5['ms_vmapped']:.4f} ms vs one per member "
                   f"{k5['ms_member_loop']:.4f} ms (device_ms); eager "
                   f"torch.func.vmap {k5['eager_vmap_ms']:.4f} ms per "
                   f"product (CUDA events, host-bound) ({card_line})")
    return {"launches": {"serve16_predict": (predict_launches, 0),
                         "serve16_single": (launches["single"][0], 0),
                         "serve16_ensemble": (launches["ensemble"][0], 0)},
            "k5": {"launches": launches["ensemble"][0],
                   "widths_single": per_fwd,
                   "widths_ensemble": widths["ensemble"][
                       :LAUNCHES_PER_FORWARD], **k5}}


def k5_vmap_times(op, widths, device, n_members=2):
    """K5's rule against the loop it replaces, over the products of one
    forward (padded widths `widths`, bf16) for `n_members` members:
    `torch.func.vmap(op.matvec)` against the member loop (the fold is
    exact per column: max abs error), then the launches the artifact
    runs, one at n_members times the width against one per member
    (`device_ms`, summed over the products), and the eager vmap's host
    time per product (`time_ms`; the artifact's graph has no functorch
    left in it)."""
    import torch

    from deepsphere_weather_torch.ops import bcsr

    kind, a, idx, nz = op.forward_layout()
    rng = np.random.default_rng(SEED + 21)
    res = {"ms_vmapped": 0.0, "ms_member_loop": 0.0, "eager_vmap_ms": 0.0,
           "max_abs_err": 0.0}
    with torch.inference_mode():
        for w in widths:
            x = torch.from_numpy(rng.standard_normal(
                (n_members, op.rows, w)).astype(np.float32)).to(
                    device, torch.bfloat16)
            vm = torch.func.vmap(op.matvec)
            y, loop = vm(x), torch.stack([op.matvec(xi) for xi in x])
            e = rel_err(y.float().cpu(), loop.float().cpu())
            if not e <= BARS["bf16"]:
                raise AssertionError(f"K5: vmapped product vs the member "
                                     f"loop {e:.3e} at width {w}")
            res["max_abs_err"] = max(res["max_abs_err"], float(
                (y.float() - loop.float()).abs().max()))
            folded = x.movedim(0, 1).reshape(op.rows, n_members * w)
            res["ms_vmapped"] += device_ms(
                lambda: bcsr.bcsr_super_spmm(a, idx, folded, nz))
            res["ms_member_loop"] += device_ms(
                lambda: [bcsr.bcsr_super_spmm(a, idx, xi, nz) for xi in x])
            res["eager_vmap_ms"] += time_ms(lambda: vm(x)) / len(widths)
    return res


# ---------------------------------------------------------------------------
# Kernel rows
# ---------------------------------------------------------------------------

def kernel_row(name, op, device, subdiv, batch, launches):
    """A kernel at the 10 shapes one forward gives it (level 0, bf16,
    batch 16): per-launch averages."""
    import torch

    L = _laplacian(subdiv)
    widths = [batch * f for f in WIDTH_FEATURES]
    rng = np.random.default_rng(SEED + 2)
    acc = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    err = 0.0
    for w in widths:
        x = torch.from_numpy(rng.standard_normal((L.shape[0], w)).astype(
            np.float32)).to(device, torch.bfloat16)
        r = measure(op, L, x, device, f"{name} bf16 width {w}")
        log("times", f"{name} HEALPix-{subdiv} bf16 width {w}: "
                     f"{r['ms']:.4f} ms (host enqueue {r['host_ms']:.4f} ms,"
                     f" bound {r['bound_ms']:.4f} ms by "
                     f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
                     f"cuSPARSE {r['library_ms']:.4f} ms), vs plain version "
                     f"{r['rel_err_plain']:.3e} (bar {BARS['bf16']:g}), "
                     f"blocks {r['blocks_nonzero']}, x blocks read "
                     f"{r['x_blocks']}")
        for k in acc:
            acc[k] += r[k] / len(widths)
        err = max(err, r["max_abs_err"])
    fwd = sum(f for f, _ in launches.values())
    bwd = sum(b for _, b in launches.values())
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": fwd + bwd,
            "launches_forward": fwd, "launches_backward": bwd,
            "launches_by_path": {p: list(v) for p, v in launches.items()},
            "max_abs_err": err, "ms": acc["ms"], "host_ms": acc["host_ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bytes_ms"] >= acc["ops_ms"]
                         else "operations"),
            "library_ms": acc["library_ms"]}


def row_range_times(kind, device, subdiv, batch):
    """A row-range kernel (K2 for kind "super", K3's row range for
    "plain") at the 10 level-0 shapes of one node16 forward (bf16, batch
    16), on rank 0's shard (rows [0, n/2)) against the full x
    (`shard_rows_times`)."""
    import torch

    from deepsphere_weather_torch.ops import BlockSparseOperator, bcsr

    L = _laplacian(subdiv)
    n = L.shape[0]
    op = BlockSparseOperator.from_scipy(
        L, dtype=torch.bfloat16, rows_per_super=2 if kind == "super" else 0,
        device=device)
    name, fn, plain = ((ROW_KERNEL, bcsr.bcsr_super_spmm_rows,
                        bcsr.bcsr_super_spmm_rows_reference)
                       if kind == "super" else
                       (PLAIN_ROW_KERNEL, bcsr.bcsr_spmm_rows,
                        bcsr.bcsr_spmm_rows_reference))
    return shard_rows_times(
        name, fn, plain, op.row_shard(0, n // 2, group=None).fwd,
        L[:n // 2], n, [batch * f for f in WIDTH_FEATURES], device,
        f"HEALPix-{subdiv} bf16 rows [0, {n // 2})",
        np.random.default_rng(SEED + 14))


def kernel_row_rows(device, subdiv, batch, launches):
    """K2's kernel row: `row_range_times` of the super-row layout."""
    r = row_range_times("super", device, subdiv, batch)
    fwd = sum(f for f, _ in launches.values())
    bwd = sum(b for _, b in launches.values())
    return {"name": ROW_KERNEL, "route": "cuda", "source": SOURCES[ROW_KERNEL],
            "replaces": REPLACES[ROW_KERNEL], "launches": fwd + bwd,
            "launches_forward": fwd, "launches_backward": bwd,
            "launches_by_path": {p: list(v) for p, v in launches.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def kernel_row_ell(parity, rows_range, f32, shipped):
    """The ELL kernel's row: per-launch averages over the train64f32
    step's shapes (`ell_step_shapes`), its launches there, in the forecast
    call and in shipped100km, the parity phase's width-1024 readings
    beside K1's and K3's gather body, its row range (`parity_ell_rows`),
    and shipped100km's voronoi and mesh shapes and configurations."""
    shapes = f32["shapes"]

    def mean(k):
        return sum(r[k] for r in shapes) / len(shapes)

    paths = {"train64f32": list(f32["launches"]),
             "train64f32_forecast": list(f32["forecast"]),
             "shipped100km": shipped["launches"],
             "shipped100km_remat": shipped["remat"],
             "shipped100km_forecast": shipped["forecast"]}
    fwd = sum(f for f, _ in paths.values())
    bwd = sum(b for _, b in paths.values())
    bytes_ms, ops_ms = mean("bytes_ms"), mean("ops_ms")
    return {"name": ELL_KERNEL, "route": "cuda",
            "source": SOURCES[ELL_KERNEL], "replaces": REPLACES[ELL_KERNEL],
            "launches": fwd + bwd, "launches_forward": fwd,
            "launches_backward": bwd, "launches_by_path": paths,
            "max_abs_err": max([r["max_abs_err"] for r in shapes]
                               + [r["max_abs_err"] for r in parity.values()]),
            "ms": mean("ms"), "host_ms": mean("host_ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": mean("library_ms"),
            "k1_fp32_ms": mean("k1_fp32_ms"),
            "train64f32_shapes": shapes, **parity,
            "rows_range": rows_range,
            "train64f32_step_ms": f32["ms"],
            "train64f32_peak_gib": f32["peak_gib"],
            "train64f32_forecast_ms": f32["forecast_ms"],
            "train64f32_card_vs_cpu": f32["card_vs_cpu"],
            "shipped100km_shapes": shipped["shapes"],
            "shipped100km_configs": shipped["configs"],
            "shipped100km_card_vs_cpu": shipped["card_vs_cpu"]}


def _profile(fn, n, label):
    """Device time by kernel over n calls of fn (torch.profiler), and the
    device's busy share of the window's host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    log("profile", f"{label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
                   f"host time ({100 * busy / wall_ms:.1f}%, profiler on)")
    for ms, count, key in rows[:15]:
        log("profile", f"{100 * ms / busy:5.1f}%  {ms / n:8.4f} ms/call  "
                       f"{count // n:4d}/call  {key[:90]}")
    for name in (KERNEL, PLAIN_KERNEL, ELL_KERNEL):
        mine = [r for r in rows if name + "_" in r[2]]
        if mine:
            t = sum(r[0] for r in mine)
            log("profile", f"{name}, all instances: {t / n:.4f} ms/call, "
                           f"{sum(r[1] for r in mine) // n}/call, "
                           f"{100 * t / busy:.1f}% of device time")


@clocked
def phase_profile(model, device, batch, train_steps, step64, step64f32,
                  n_fwd=3, n_steps=2):
    import torch

    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.standard_normal(
        (batch, len(INPUT_K), model.input_n_node,
         F_STATIC + F_BC + F_DYN)).astype(np.float32)).to(device)

    def forward():
        with torch.inference_mode():
            model(x)

    _profile(forward, n_fwd, f"{n_fwd} forwards, batch {batch}")
    for label, step in train_steps.items():
        _profile(step, n_steps, f"{n_steps} AR{TRAIN_AR} train steps, batch "
                                f"{batch}, {label} at level 0")
    _profile(step64, n_steps, f"{n_steps} HEALPix-{BIG_SUBDIV} AR{HP64_AR} "
                              f"train steps, batch {HP64_BATCH}, K1 at every "
                              "level")
    _profile(step64f32, n_steps, f"{n_steps} train64f32 steps ({F32_CONFIG}, "
                                 f"fp32, AR{HP64_AR}, batch {HP64_BATCH}), "
                                 "the ELL kernel at levels 0-1")


# ---------------------------------------------------------------------------
# bn16, ens16, swag16: probabilistic forecasting on the flagship
# ---------------------------------------------------------------------------

def _step_launches(model, step):
    """Wrap `step` (of TRAIN_AR + 1 model calls, no remat) so that each
    call records its (forward, backward) K1 launches into the returned
    list while the returned hook is on (`split_launches`)."""
    run, hook = split_launches(model, TRAIN_AR + 1)
    per_step = []

    def counted(*args):
        out, split = run(lambda: step(*args))
        if split is not None:           # while the hook is on
            per_step.append(tuple(s[KERNEL] for s in split))
        return out
    return counted, per_step, hook


def _want_step_launches(per_step, label, phase):
    want = (LAUNCHES_PER_FORWARD * (TRAIN_AR + 1),
            LAUNCHES_PER_FORWARD * (TRAIN_AR + 1) - NO_GRAD_PRODUCTS)
    for i, got in enumerate(per_step):
        if tuple(got) != want:
            raise AssertionError(f"{label} step {i}: {got} forward and "
                                 f"backward {KERNEL} launches, want {want}")
    log(phase, f"{label}: {want[0]} forward + {want[1]} backward {KERNEL} "
               f"launches in each of {len(per_step)} steps")
    return want[0] * len(per_step), want[1] * len(per_step)


def _fp32_step(device, params, seed_batch, members=None, clip=None,
               pinned=None, remat=False):
    """One fp32 batch-2 step of the flagship (level 0 block-sparse) with
    its gradients kept: losses, gradients (clipped when `clip`) and the
    parameters after it, its ReLU and max-pool decisions (`steer`; taken
    from `pinned` when given) and how far those that differed from its own
    sat from their kink or tie. `members` (a list of state dicts) runs the
    member step over their stack instead, its decisions stacked over the
    members; `remat` recomputes each AR iteration in the backward."""
    from deepsphere_weather_torch.engine import (
        Adam,
        make_member_train_step,
        make_train_step,
    )
    from deepsphere_weather_torch.models import MemberStack
    from torch_steer import steer

    model = build_flagship(device, SLICE_SUBDIV, params, precision="float32",
                           dense_threshold=FP32_DENSE_THRESHOLD).train()
    decisions, gaps = steer(model, pinned,
                            None if members is None else len(members))
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, TRAIN_CHECK_BATCH,
                       device, seed_batch)
    owner = model if members is None else MemberStack.from_states(model,
                                                                  members)
    opt = Adam(owner.parameters(), lr=LR, gradient_clipping=clip or 0.0,
               member_axis=members is not None, eps=ENS_CHECK_EPS)
    make = make_train_step if members is None else make_member_train_step
    _, per_iter = make(owner, indexer, opt, TRAIN_AR + 1,
                       remat=remat)(data, w, area_w)
    return {"per_iter": per_iter.detach().cpu().double(),
            "grads": {k: p.grad.detach().cpu().double()
                      for k, p in owner.named_parameters()},
            "params": {k: p.detach().cpu().double()
                       for k, p in owner.named_parameters()},
            "decisions": decisions, "gaps": gaps}


@clocked
def phase_bn16(device, card_line):
    """bn16: the flagship with BatchNorm. 3 with_norm_state steps (bf16,
    AR6, batch 16): exactly 70 + 68 K1 launches each, the running
    statistics finite and moved by every step; one fp32 batch-2 step on
    the card against the CPU with the card's decisions (`steer`): losses,
    gradients and running statistics at the 3e-2 bar; `bn_update` over a
    few toy batches, then an eval-mode 20-step forecast of 16 histories:
    finite, 10 K1 launches per forward."""
    import torch

    from deepsphere_weather_torch.data import (
        GlobalStandardScaler,
        generate_toy_data,
    )
    from deepsphere_weather_torch.engine import (
        make_ar_loss_fn,
        make_rollout_block,
        make_train_step,
    )
    from deepsphere_weather_torch.engine.step import fold_running_stats
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.prob import bn_update
    from torch_grad_terms import cancelling_norm_biases, term_sums
    from torch_steer import steer

    t_phase = time.perf_counter()
    model = build_flagship(device, SLICE_SUBDIV, batch_norm=True).train()
    model.load_state_dict(train_params(model, SEED + 20))
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, BATCH, device, SEED + 21)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=ADAM_EPS)
    step, per_step, hook = _step_launches(model, make_train_step(
        model, indexer, opt, TRAIN_AR + 1, with_norm_state=True))
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, step_stats = [], []
    for i in range(BN_STEPS):
        before = {k: v.clone() for k, v in model.norm_state().items()}
        total, _ = step(data, w, area_w)
        losses.append(float(total))
        for k, v in model.norm_state().items():
            if not bool(torch.isfinite(v).all()) or torch.equal(v, before[k]):
                raise AssertionError(f"bn16 step {i}: running {k} not "
                                     "finite or not moved")
        step_stats.append({k: v.float().cpu().numpy().copy()
                           for k, v in model.norm_state().items()})
    hook.remove()
    train_launches = dict(launch_counts)
    f_train, b_train = _want_step_launches(per_step, f"bn16 HEALPix-"
                                           f"{SLICE_SUBDIV} AR{TRAIN_AR} batch "
                                           f"{BATCH} bf16", "bn16")
    if sum(train_launches.values()) != f_train + b_train:
        raise AssertionError(f"bn16: launches {train_launches}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"bn16 losses {losses}")
    t_step = time_steps({"bn16": lambda: step(data, w, area_w)}, BATCH,
                        card_line, SMOKE_WINDOWS, SMOKE_STEPS)["bn16"]

    # one fp32 batch-2 step, card vs CPU (the CPU takes the card's
    # ReLU and max-pool decisions)
    params = train_params(model, SEED + 22)
    runs = []
    decisions = None
    for dev in (device, torch.device("cpu")):
        m = build_flagship(dev, SLICE_SUBDIV, params, precision="float32",
                           dense_threshold=FP32_DENSE_THRESHOLD,
                           batch_norm=True).train()
        decisions, gaps = steer(m, None if dev == device else decisions)
        sums = term_sums(m)
        idx, aw, ww = train_setup(m, TRAIN_AR)
        d = train_batch(idx, m.input_n_node, TRAIN_CHECK_BATCH, dev,
                        SEED + 23)
        total, (per_iter, stats) = make_ar_loss_fn(
            m, idx, TRAIN_AR + 1, collect_stats=True)(d, ww, aw)
        total.backward()
        fold_running_stats(m.norm_state(), stats)
        runs.append((per_iter.detach().cpu().numpy(), grads_of(m),
                     {k: v.detach().cpu().double()
                      for k, v in m.norm_state().items()}, sums, gaps))
    (pi, g, st, _, _), (pi_c, g_c, st_c, sums, gaps) = runs
    e_loss = rel_err(pi, pi_c)
    # a norm bias feeding another BatchNorm block: held against its
    # block's norm scale (`cancelling_norm_biases`)
    for k, scale_key in cancelling_norm_biases(model).items():
        sums[k] = float(g_c[scale_key].abs().max())
    e_grad, worst = grads_close(g, g_c, sums, SLICE_TOL, "bn16 card vs CPU")
    e_stats = max(rel_err(st[k].numpy(), st_c[k].numpy()) for k in st)
    log("bn16", f"fp32 batch {TRAIN_CHECK_BATCH} step (level 0 "
                f"block-sparse), card vs CPU with the card's decisions "
                f"({len(gaps)} differed, gaps up to "
                f"{max(gaps, default=0.0):.2e}): per-iteration losses "
                f"{e_loss:.3e}, gradients worst {e_grad:.3e} ({worst}), "
                f"running statistics {e_stats:.3e}; bar {SLICE_TOL}")
    if not (e_loss <= SLICE_TOL and e_stats <= SLICE_TOL):
        raise AssertionError(f"bn16 card vs CPU: losses {e_loss:.3e}, "
                             f"statistics {e_stats:.3e}")

    # bn_update over toy batches, then an eval-mode forecast of 16
    # histories of the same (scaled) toy store
    root = tempfile.mkdtemp(prefix="dsw_bn16_")
    try:
        dyn, bc, static = generate_toy_data(
            os.path.join(root, "data"), sampling_kwargs={
                "subdivisions": SLICE_SUBDIV, "nest": True},
            n_timesteps=BN_UPDATE_STEPS, seed=SEED + 24)
        scaler = GlobalStandardScaler().fit_dataset(dyn)
        scaler_bc = GlobalStandardScaler().fit_dataset(bc)
        reset_launch_counts()
        t0 = time.perf_counter()
        state = bn_update(model, data_dynamic=dyn, data_bc=bc,
                          data_static=static, scaler=scaler,
                          scaler_bc=scaler_bc, input_k=list(INPUT_K),
                          output_k=[0], forecast_cycle=1,
                          ar_iterations=TRAIN_AR, batch_size=BATCH,
                          max_batches=BN_UPDATE_BATCHES, num_workers=2)
        torch.cuda.synchronize()
        t_bn = time.perf_counter() - t0
        bn_launches = launch_counts[KERNEL]
        rollout, H = make_rollout_block(model, indexer, N_STEPS,
                                        norm_state=state)
        in_k = np.asarray(INPUT_K)
        t0s = np.random.default_rng(SEED + 25).integers(
            H, dyn.n_time - N_STEPS, size=BATCH)
        hist = np.stack([scaler.transform(dyn.read_stacked(
            np.arange(t - H + 1, t + 1))) for t in t0s])
        bcs = np.stack([np.stack([scaler_bc.transform(bc.read_stacked(
            t + s + in_k)) for s in range(N_STEPS)]) for t in t0s])
        static_t = static.read_stacked()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = BN_UPDATE_BATCHES * LAUNCHES_PER_FORWARD * (TRAIN_AR + 1)
    if bn_launches != want or not all(bool(torch.isfinite(v).all())
                                      for v in state.values()):
        raise AssertionError(f"bn_update: {bn_launches} launches (want "
                             f"{want}), statistics finite "
                             f"{[bool(torch.isfinite(v).all()) for v in state.values()]}")
    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    reset_launch_counts()
    with torch.inference_mode():
        _, _, preds = rollout(dev(hist), None, dev(bcs), dev(static_t))
    torch.cuda.synchronize()
    fc_launches = launch_counts[KERNEL]
    if (not bool(torch.isfinite(preds).all())
            or fc_launches != LAUNCHES_PER_FORWARD * N_STEPS):
        raise AssertionError(f"bn16 eval forecast: finite "
                             f"{bool(torch.isfinite(preds).all())}, "
                             f"{fc_launches} launches")
    log("bn16", f"bn_update {BN_UPDATE_BATCHES} toy batches of {BATCH} "
                f"(AR{TRAIN_AR}, {bn_launches} {KERNEL} launches) "
                f"{t_bn:.2f} s; eval-mode forecast {tuple(preds.shape)} "
                f"finite, {fc_launches} launches ({LAUNCHES_PER_FORWARD} per "
                f"forward); step {t_step:.2f} ms; phase "
                f"{time.perf_counter() - t_phase:.1f} s ({card_line})")
    return {"launches": {"bn16_train": (f_train, b_train),
                         "bn16_bn_update": (bn_launches, 0),
                         "bn16_forecast": (fc_launches, 0)},
            "ms": t_step, "losses": losses, "stats": step_stats}


@clocked
def phase_ens16(device, card_line, single_ms, profile=False):
    """ens16: 2 flagship members trained together (bf16, AR6, batch 16,
    member step: each AR iteration under vmap, one backward). 3 steps:
    exactly 70 + 68 K1 launches per step for both members, at twice the
    single step's widths (but the first convolution's 2 products on the
    shared batch); then one
    fp32 batch-2 member step against each member's single step on the
    card (1e-4), with a clip between the members' gradient norms, the
    single steps taking the member step's ReLU and max-pool decisions
    (each that differs within KINK_TOL of its kink or tie). With
    `profile`, the device time of 2 member steps and of 2 single steps on
    the same batch (`_profile`)."""
    import torch

    from deepsphere_weather_torch.engine import (
        Adam,
        make_member_train_step,
        make_train_step,
    )
    from deepsphere_weather_torch.models import MemberStack
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    t_phase = time.perf_counter()
    model = build_flagship(device, SLICE_SUBDIV).train()
    members = [train_params(model, SEED + 30 + m) for m in range(ENS_MEMBERS)]
    model.load_state_dict(members[0])
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, BATCH, device, SEED + 32)
    single = make_train_step(model, indexer, torch.optim.Adam(
        model.parameters(), lr=LR, eps=ADAM_EPS), TRAIN_AR + 1)
    single_widths = record_widths(lambda: single(data, w, area_w))
    stack = MemberStack.from_states(model, members)
    opt = Adam(stack.parameters(), lr=LR, member_axis=True)
    step, per_step, hook = _step_launches(model, make_member_train_step(
        stack, indexer, opt, TRAIN_AR + 1))
    torch.cuda.synchronize()
    reset_launch_counts()
    widths = record_widths(lambda: step(data, w, area_w))
    losses = []
    for _ in range(ENS_STEPS - 1):
        total, _ = step(data, w, area_w)
        losses.append(total.float().cpu().numpy())
    hook.remove()
    ens_launches = dict(launch_counts)
    f_ens, b_ens = _want_step_launches(per_step, f"ens16 {ENS_MEMBERS} "
                                       f"members, HEALPix-{SLICE_SUBDIV} "
                                       f"AR{TRAIN_AR} batch {BATCH} bf16",
                                       "ens16")
    if sum(ens_launches.values()) != f_ens + b_ens:
        raise AssertionError(f"ens16: launches {ens_launches}")
    shared = NO_GRAD_PRODUCTS
    if (len(widths) != len(single_widths)
            or widths[:shared] != single_widths[:shared]
            or widths[shared:] != [2 * x for x in single_widths[shared:]]):
        raise AssertionError(f"ens16 widths {widths} vs single "
                             f"{single_widths}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"ens16 losses {losses}")
    ms = time_steps({"ens16 member step": lambda: step(data, w, area_w)},
                    BATCH, card_line, SMOKE_WINDOWS,
                    SMOKE_STEPS)["ens16 member step"]
    log("ens16", f"widths: {len(widths)} K1 launches a member step, "
                 f"{shared} at the single widths (shared input) and the rest "
                 f"at twice: {sorted(set(widths))} vs single "
                 f"{sorted(set(single_widths))}; member step {ms:.2f} ms "
                 f"for {ENS_MEMBERS} members vs the single step "
                 f"{single_ms:.2f} ms ({ms / single_ms:.2f}x; "
                 f"{card_line})")
    if profile:
        _profile(lambda: single(data, w, area_w), 2,
                 f"2 single steps beside ens16, AR{TRAIN_AR} batch {BATCH}")
        _profile(lambda: step(data, w, area_w), 2,
                 f"2 ens16 member steps, {ENS_MEMBERS} members, AR{TRAIN_AR} "
                 f"batch {BATCH}")

    # fp32 batch-2: the member step against each member's single step
    fp32 = [train_params(model, SEED + 33 + m) for m in range(ENS_MEMBERS)]
    fp32[1]["res_increment"] = fp32[1]["res_increment"] * 3
    norms = []
    for p in fp32:
        r = _fp32_step(device, p, SEED + 35)
        norms.append(float(sum((g ** 2).sum() for g in r["grads"].values())
                           ** 0.5))
    clip = float(np.sqrt(norms[0] * norms[1]))
    mem = _fp32_step(device, None, SEED + 35, members=fp32, clip=clip)
    worst = {"losses": (0.0, ""), "grads": (0.0, ""), "params": (0.0, "")}
    gaps = []
    for m, p in enumerate(fp32):
        # each member's single step takes the member step's ReLU and
        # max-pool decisions: the two round the dense products apart
        # (batched GEMMs), and one decision that flips with that rounding
        # moves a weight's gradient by that one term, far above the
        # rounding
        one = _fp32_step(device, p, SEED + 35, clip=clip,
                         pinned=[d[m] for d in mem["decisions"]])
        gaps += one["gaps"]
        worst["losses"] = max(worst["losses"], (rel_err(
            mem["per_iter"][m].numpy(), one["per_iter"].numpy()),
            f"member {m}"))
        for part in ("grads", "params"):
            # a one-element tensor (a ReZero weight, the increment scale:
            # one sum over a block's output, whose terms cancel) against
            # the largest of the set
            top = max(float(r.abs().max()) for r in one[part].values())
            e, key = grads_close(
                {k: v[m] for k, v in mem[part].items()}, one[part],
                {k: top for k, r in one[part].items() if r.numel() == 1},
                ENS_TOL, f"ens16 member {m} {part} vs its single step")
            worst[part] = max(worst[part], (e, f"member {m} {key}"))
    log("ens16", f"fp32 batch {TRAIN_CHECK_BATCH} member step vs each "
                 f"member's single step: gradient norms "
                 f"{np.round(norms, 4).tolist()}, clip {clip:.4f} (member "
                 f"{int(np.argmax(norms))} clips), Adam eps "
                 f"{ENS_CHECK_EPS:g}; the single steps on the member "
                 f"step's decisions ({len(gaps)} differed from their own, "
                 f"up to {max(gaps, default=0.0):.2e} from their kink or "
                 f"tie, bar {KINK_TOL:g}), worst: "
                 + ", ".join(f"{k} {e:.3e} ({key})"
                             for k, (e, key) in worst.items())
                 + f" (bar {ENS_TOL}); phase "
                 f"{time.perf_counter() - t_phase:.1f} s")
    if not all(e <= ENS_TOL for e, _ in worst.values()) or \
            max(gaps, default=0.0) > KINK_TOL:
        raise AssertionError(f"ens16 member vs single {worst}, decision "
                             f"gaps {gaps}")
    return {"launches": {"ens16_train": (f_ens, b_ens)}, "ms": ms,
            "widths": widths, "single_widths": single_widths}


@clocked
def phase_swag16(device, card_line, proto):
    """swag16: `cli.finetune_swag.main` on protocol16's trained flagship
    (1 epoch, 2 members, collection every 2nd scoring, AR5 on the toy
    test period), K1's launches by part; then `cli.export_model
    --swag_samples 2`: one block of the artifact, 10 K1 launches per
    forward at twice the widths."""
    import torch

    from deepsphere_weather_torch.cli.common import (
        load_experiment_model,
        open_datasets,
    )
    from deepsphere_weather_torch.cli.export_model import main as export_main
    from deepsphere_weather_torch.cli.finetune_swag import main as finetune
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.serve import load_artifact

    t_phase = time.perf_counter()
    exp = proto["exp"]
    rec, undo = _instrument_protocol()
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, gs = finetune(exp, proto["data"], epochs=1,
                           nb_samples=SWAG_SAMPLES, swag_freq=SWAG_FREQ,
                           ar_iterations_prediction=SWAG_AR_PREDICT,
                           device=device, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(launch_counts)
    finally:
        undo()
        torch.use_deterministic_algorithms(False)
    parts = {k: rec[k] for k in ("train_forward", "train_backward",
                                 "validation", "predict")}
    if any(n <= 0 for n in parts.values()) or (
            launches[KERNEL] != sum(parts.values())
            or sum(launches.values()) != launches[KERNEL]):
        raise AssertionError(f"swag16 launches {launches}, parts {parts}")
    with np.load(os.path.join(exp, "model_weights", "model_swag.npz")) as z:
        n_models = int(z["scalars"][0])
        swag_finite = all(np.isfinite(z[k]).all() for k in z.files)
    if n_models < 2 or not swag_finite:
        raise AssertionError(f"model_swag.npz: {n_models} models, finite "
                             f"{swag_finite}")
    V = 12 * SLICE_SUBDIV ** 2
    for fc in out["members"] + [out["median"]]:
        arr = np.stack([fc.variables[n][...] for n in fc.feature_order], -1)
        want = (fc.n_frt, SWAG_AR_PREDICT + 1, V, F_DYN)
        if arr.shape != want or not np.isfinite(arr).all():
            raise AssertionError(f"swag16 store {arr.shape}, want {want}")
    ens = out["ensemble"]
    e0 = ens.variables[ens.feature_order[0]]
    if e0.shape[0] != SWAG_SAMPLES or not np.isfinite(e0[...]).all():
        raise AssertionError(f"ensemble store {e0.shape}")
    rmse = np.asarray(gs["RMSE"])
    with np.load(os.path.join(exp, "model_skills",
                              "swag_probabilistic_global_skill.npz")) as z:
        crps = np.asarray(z["skill_CRPS"])
    if not (np.isfinite(rmse).all() and np.isfinite(crps).all()
            and (crps[SWAG_AR_PREDICT] > crps[1]).all()):
        raise AssertionError(f"median RMSE {rmse}, CRPS lead 1 {crps[1]} "
                             f"-> {crps[SWAG_AR_PREDICT]}")
    secs = rec["seconds"]
    n_frt = out["members"][0].n_frt
    log("swag16", f"finetune_swag: {rec['train_steps']} updates, "
                  f"{n_models} SWAG models, {SWAG_SAMPLES} members x "
                  f"{n_frt} reference times AR{SWAG_AR_PREDICT}, "
                  f"stores finite; median RMSE lead 1 "
                  f"{np.round(rmse[1], 4).tolist()} -> lead "
                  f"{SWAG_AR_PREDICT} "
                  f"{np.round(rmse[SWAG_AR_PREDICT], 4).tolist()}, CRPS "
                  f"{np.round(crps[1], 4).tolist()} -> "
                  f"{np.round(crps[SWAG_AR_PREDICT], 4).tolist()}; "
                  f"{KERNEL} launches {parts} = {launches[KERNEL]}")
    predict_s = wall - secs.get("train", 0.0)
    log("swag16", f"wall seconds: main {wall:.1f} (fine-tune "
                  f"{secs.get('train', float('nan')):.1f}, members, stores "
                  f"and verification {predict_s:.1f}: "
                  f"{predict_s / SWAG_SAMPLES:.1f} s per member) "
                  f"({card_line})")

    # the SWAG-sampled ensemble artifact
    art = os.path.join(proto["root"], "artifact_swag")
    t0 = time.perf_counter()
    export_main(exp, proto["data"], out=art, batch_size=BATCH,
                block_size=BLOCK, swag_samples=SWAG_EXPORT,
                device=device, verbose=False)
    t_export = time.perf_counter() - t0
    rollout, _, _ = load_artifact(art)
    m = rollout.meta
    rng = np.random.default_rng(SEED + 40)
    hist = rng.standard_normal((SWAG_EXPORT, m["batch_size"],
                                m["history_size"], m["n_node"],
                                m["n_dynamic_features"])).astype(np.float32)
    bc = rng.standard_normal((m["batch_size"], m["block_size"],
                              m["n_input_k"], m["n_node"],
                              m["n_bc_features"])).astype(np.float32)
    reset_launch_counts()
    called = []
    widths = record_widths(lambda: called.append(rollout.call(hist, bc)))
    preds = called[0][1]
    export_launches = launch_counts[KERNEL]
    n_fwd = m["block_size"]
    _, model = load_experiment_model(exp, open_datasets(proto["data"]),
                                     device)
    x = torch.zeros((m["batch_size"], m["n_input_k"], m["n_node"],
                     F_STATIC + F_BC + F_DYN), device=device)
    with torch.no_grad():
        single = record_widths(lambda: model(x))
    if (len(widths) != LAUNCHES_PER_FORWARD * n_fwd
            or export_launches != len(widths)
            or widths[:LAUNCHES_PER_FORWARD] != [2 * x for x in single]
            or not bool(torch.isfinite(preds).all())):
        raise AssertionError(f"swag16 artifact: {len(widths)} launches for "
                             f"{n_fwd} forwards, widths "
                             f"{widths[:LAUNCHES_PER_FORWARD]} vs single "
                             f"{single}")
    log("swag16", f"export --swag_samples {SWAG_EXPORT} {t_export:.1f} s; "
                  f"one block ({n_fwd} steps, batch {m['batch_size']}): "
                  f"{len(widths)} {KERNEL} launches ({LAUNCHES_PER_FORWARD} "
                  f"per forward), widths {widths[:LAUNCHES_PER_FORWARD]} = "
                  f"twice the single model's; phase "
                  f"{time.perf_counter() - t_phase:.1f} s ({card_line})")
    fwd = parts["train_forward"] + parts["validation"] + parts["predict"]
    return {"launches": {"swag16": (fwd, parts["train_backward"]),
                         "swag16_export": (export_launches, 0)},
            "parts": parts}


# ---------------------------------------------------------------------------
# grids400: every sampling, graph type and pool method at 400 km
# ---------------------------------------------------------------------------

def _grids_config(name):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "UNetSpherical", f"{name}.json")) as f:
        return json.load(f)


def grids_model(device, cfg, precision, dense_threshold=None):
    """The config's model through `models.get_model`, as the CLI builds it,
    at the smoke's tensor_info, in `precision`."""
    from deepsphere_weather_torch.models import get_model
    from deepsphere_weather_torch.sphere import build_sampling

    ms = cfg["model_settings"]
    kw = {k: v for k, v in ms.items() if k != "architecture_name"}
    kw["pool_method"] = str(kw["pool_method"]).lower()
    n = build_sampling(ms["sampling"], dict(ms["sampling_kwargs"])).n_nodes
    return get_model(ms["architecture_name"], tensor_info(n), device=device,
                     numeric_precision=precision,
                     dense_threshold=dense_threshold, **kw)


def _grid_laplacian(cfg, geometry):
    """level -> the config's prepared Laplacian at that level (scipy)."""
    from deepsphere_weather_torch.models.geometry import cached_graph_laplacian

    ms = cfg["model_settings"]
    return lambda level: cached_graph_laplacian(
        ms["sampling"], geometry.samplings[level].kwargs_dict, ms["knn"],
        ms["graph_type"])[1]


def _layout_blocks(n, a, idx):
    """'nonzero/total' 128x128 blocks of the n x n matrix a super-row
    layout holds, and the layout's union width max_u."""
    nnz, _, _ = _block_counts(KERNEL, a, idx)
    n_rb = -(-n // 128)
    return f"{nnz}/{n_rb * n_rb} (max_u {idx.shape[1]})"


class _Transposed:
    """An operator's transposed layout as a forward one, for `measure`."""

    def __init__(self, op):
        self.op, self.rows = op, op.rows

    def forward_layout(self):
        return self.op.transpose_layout()


def grids_card_vs_cpu(device, cfg, params, label, ar=GRIDS_CHECK_AR,
                      batch=TRAIN_CHECK_BATCH,
                      dense_threshold=FP32_DENSE_THRESHOLD, phase="grids400"):
    """The fp32 loss and gradients (batch `batch`, AR`ar`) of the config's
    model (level 0 block-sparse at `dense_threshold`) on the card and on
    the CPU plain path, the CPU taking the card's ReLU and argmax-pool
    decisions (`steer`): per
    parameter key at GRAD_BAR, learned logits included, one-element
    gradients against the sum of their terms' magnitudes; every decision
    that differed within KINK_TOL of its kink or tie."""
    import torch

    from deepsphere_weather_torch.engine import make_ar_loss_fn
    from torch_grad_terms import term_sums
    from torch_steer import steer

    runs, decisions = [], None
    for dev in (device, torch.device("cpu")):
        m = grids_model(dev, cfg, "float32",
                        dense_threshold=dense_threshold).train()
        if m.geometry.cheb_ops[0].bcsr is None:
            raise AssertionError(f"{label}: fp32 level 0 must be "
                                 "block-sparse")
        m.load_state_dict(params)
        decisions, gaps = steer(m, None if dev == device else decisions)
        sums = term_sums(m)
        indexer, area_w, w = train_setup(m, ar)
        data = train_batch(indexer, m.input_n_node, batch, dev, SEED + 31)
        total, per_iter = make_ar_loss_fn(m, indexer, ar + 1)(data, w,
                                                              area_w)
        total.backward()
        runs.append((per_iter.detach().cpu().numpy(), grads_of(m), sums,
                     gaps))
    (pi, g, _, _), (pi_c, g_c, sums, gaps) = runs
    e_loss = rel_err(pi, pi_c)
    e_grad, worst = grads_close(g, g_c, sums, GRAD_BAR, f"{label} card vs CPU")
    logits = sorted(k for k in g if k.startswith(("pool", "unpool")))
    log(phase, f"{label}: fp32 batch {batch} AR{ar} loss and gradients "
               f"(level 0 block-sparse fp32), card vs CPU with the card's "
               f"decisions ({len(gaps)} differed, up to "
               f"{max(gaps, default=0.0):.2e} from their kink or tie, bar "
               f"{KINK_TOL:g}): per-iteration losses {e_loss:.3e}, {len(g)} "
               f"gradients worst {e_grad:.3e} ({worst})"
               f"{', learned logits ' + str(logits) if logits else ''}; "
               f"bar {GRAD_BAR:g}")
    if not (e_loss <= GRAD_BAR and max(gaps, default=0.0) <= KINK_TOL):
        raise AssertionError(f"{label} card vs CPU: losses {e_loss:.3e}, "
                             f"decision gaps {gaps}")
    return {"losses": e_loss, "gradients": e_grad, "worst_key": worst}


def grids_config(device, name, index, card_line):
    """One grids400 configuration (module docstring). Returns its K1
    launches (training forward, backward; forecast), step and forecast ms,
    geometry seconds and, for the voronoi O24 config, its timed rows."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.sphere import cache_dir

    cfg = _grids_config(name)
    t_cfg = time.perf_counter()
    model = grids_model(device, cfg, "bfloat16").train()
    t_geom = time.perf_counter() - t_cfg
    geom = model.geometry
    op = geom.cheb_ops[0].bcsr
    if (op is None or op.svals.dtype != torch.bfloat16
            or any(o.bcsr is not None for o in geom.cheb_ops[1:])):
        raise AssertionError(f"{name}: level 0 alone must run the bf16 "
                             "block-sparse operator")
    voronoi = cfg["model_settings"]["graph_type"] == "voronoi"
    if op.symmetric == voronoi:
        raise AssertionError(f"{name}: symmetric {op.symmetric}")
    blocks = f"forward layout {_layout_blocks(op.n, op.svals, op.ucols)}"
    if voronoi:
        blocks += (", transposed layout "
                   f"{_layout_blocks(op.n, op.svals_t, op.ucols_t)}")
    log("grids400", f"{name}: levels {geom.n_nodes}, pools "
                    f"{type(geom.pools[0]).__name__}/"
                    f"{type(geom.unpools[0]).__name__}; level 0 bf16 "
                    f"nonzero/total 128x128 blocks: {blocks}; geometry "
                    f"built in {t_geom:.1f} s (host, remap overlaps "
                    f"native; disk cache "
                    f"{cache_dir()})")

    params = train_params(model, SEED + 30 + index)
    model.load_state_dict(params)
    clip = cfg["training_settings"]["gradient_clipping"]
    label = f"{name} AR{TRAIN_AR} batch {BATCH}"
    res = run_train(model, TRAIN_AR, BATCH, GRIDS_STEPS, label, clip=clip,
                    phase="grids400")
    train = check_launches(res, KERNEL, LAUNCHES_PER_FORWARD, TRAIN_AR + 1,
                           label, phase="grids400")
    step_ms = time_steps({label: res["step"]}, BATCH, card_line,
                         GRIDS_TIME_WINDOWS, SMOKE_STEPS)[label]
    laplacian = _grid_laplacian(cfg, geom)
    t0 = time.perf_counter()
    products = check_step_products(model, res["step"], None, laplacian,
                                   phase="grids400", name=name)
    t_products = time.perf_counter() - t0
    grids_card_vs_cpu(device, cfg, params, name)
    t_cpu = time.perf_counter() - t0 - t_products

    # a 20-step forecast of 16 histories through ForecastService
    t_service = time.perf_counter()
    svc, rollout, hist, bc, _ = synthetic_service(
        model.eval(), None, BATCH, N_STEPS,
        np.random.default_rng(SEED + 32 + index))
    forwards = count_forwards(rollout)
    svc.predict(hist, n_steps=BLOCK, bc=bc[:, :BLOCK])  # warm-up
    reset_launch_counts()
    forwards[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = svc.predict(hist, n_steps=N_STEPS, bc=bc)
    torch.cuda.synchronize()
    fc_ms = 1e3 * (time.perf_counter() - t0) / N_STEPS
    svc.close()
    t_service = time.perf_counter() - t_service
    fc = launch_counts[KERNEL]
    V = model.input_n_node
    if (out.shape != (BATCH, N_STEPS, 1, V, F_DYN) or not np.isfinite(out).all()
            or fc != LAUNCHES_PER_FORWARD * forwards[0] or not forwards[0]
            or sum(launch_counts.values()) != fc):
        raise AssertionError(f"{name} forecast {out.shape} finite "
                             f"{np.isfinite(out).all()}, launches "
                             f"{dict(launch_counts)} for {forwards[0]} "
                             "forwards")
    rows = None
    if name == GRIDS_CLI:
        rows = grids_kernel_rows(op, laplacian(0), products, device,
                                 card_line)
    log("grids400", f"{name}: train step {step_ms:.2f} ms (batch {BATCH}, "
                    f"AR{TRAIN_AR}), {train[0]} + {train[1]} {KERNEL} "
                    f"launches over {GRIDS_STEPS} steps; forecast "
                    f"{out.shape} finite, {fc_ms:.2f} ms per step ({fc} "
                    f"launches, {LAUNCHES_PER_FORWARD} per forward); "
                    f"config {time.perf_counter() - t_cfg:.1f} s, of it "
                    f"geometry {t_geom:.1f} s, product checks "
                    f"{t_products:.1f} s, card vs CPU {t_cpu:.1f} s, export "
                    f"and forecast {t_service:.1f} s ({card_line})")
    return {"train": train, "forecast": (fc, 0), "step_ms": step_ms,
            "forecast_ms": fc_ms, "geometry_s": t_geom, "rows": rows,
            "seconds": time.perf_counter() - t_cfg}


def grids_kernel_rows(op, L, products, device, card_line):
    """K1 per launch on a voronoi level 0, forward layout and its
    transposed one (the backward's), at each width the training step
    gives level 0: time (`device_ms`) beside the bound over its nonzero
    blocks and cuSPARSE's time of the same product (L, resp. L^T),
    held to its plain version (in `measure`). One entry per (layout,
    width)."""
    import torch

    rng = np.random.default_rng(SEED + 33)
    out = {}
    widths = sorted({w for level, w, dt, _ in products if level == 0})
    for kind, lop, mat in (("forward", op, L), ("transposed", _Transposed(op),
                                                 L.T.tocsr())):
        out[kind] = []
        for w in widths:
            x = torch.from_numpy(rng.standard_normal(
                (mat.shape[0], w)).astype(np.float32)).to(device,
                                                          torch.bfloat16)
            r = measure(lop, mat, x, device, f"{GRIDS_CLI} {kind} width {w}")
            log("grids400", f"{KERNEL} {GRIDS_CLI} level 0 {kind} layout "
                            f"x[{mat.shape[0]}, {w}]: {r['ms']:.4f} ms (bound "
                            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
                            f"plain {r['plain_ms']:.4f} ms, cuSPARSE "
                            f"{r['library_ms']:.4f} ms), blocks "
                            f"{r['blocks_nonzero']}, vs plain version "
                            f"{r['rel_err_plain']:.3e} ({card_line})")
            out[kind].append({"width": w, **{k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err")}})
    return out


def grids_cli(device, card_line):
    """The O24 MaxVal voronoi config through the entry points a user
    calls: `cli.train_predict.main` in bf16 on toy O24 data (1 epoch, AR20
    predict, verify), `cli.export_model` of the experiment, loaded in a
    fresh ForecastService with the geometry builder refused, its first
    step against the in-process rollout of the same weights. Returns the
    K1 launches (forward, backward) and seconds."""
    import torch

    from deepsphere_weather_torch.cli.common import (
        load_experiment_model,
        open_datasets,
    )
    from deepsphere_weather_torch.cli.export_model import main as export_main
    from deepsphere_weather_torch.cli.train_predict import main as train_main
    from deepsphere_weather_torch.data import generate_toy_data
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine.prediction import ForecastDataset
    from deepsphere_weather_torch.engine.step import make_rollout_block
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.serve import ForecastService

    t_cli = time.perf_counter()
    cfg = _grids_config(GRIDS_CLI)
    ms = cfg["model_settings"]
    root = tempfile.mkdtemp(prefix="dsw_grids400_")
    try:
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        generate_toy_data(data, sampling=ms["sampling"],
                          sampling_kwargs=ms["sampling_kwargs"],
                          n_timesteps=GRIDS_CLI_STEPS, seed=SEED)
        t_data = time.perf_counter() - t0
        cfg["training_settings"].update(numeric_precision="bfloat16",
                                        epochs=GRIDS_CLI_EPOCHS,
                                        scoring_interval=CLI_SCORING)
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        rec, undo = _instrument_protocol()
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            exp, gs = train_main(cfg_path, data, os.path.join(root, "exp"),
                                 force=True,
                                 ar_iterations_prediction=CLI_AR_PREDICT,
                                 device=device, verbose=False)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
            launches = dict(launch_counts)
        finally:
            undo()
            torch.use_deterministic_algorithms(False)
        parts = {k: rec[k] for k in ("train_forward", "train_backward",
                                     "validation", "predict")}
        if (min(parts.values()) <= 0 or launches[KERNEL] != sum(parts.values())
                or sum(launches.values()) != launches[KERNEL]):
            raise AssertionError(f"{GRIDS_CLI} CLI launches {launches}, by "
                                 f"part {parts}")
        with open(os.path.join(exp, "training_info",
                               "ar_training_info.json")) as f:
            info = json.load(f)
        losses = info["training_total_loss"] + info["validation_total_loss"]
        fc = ForecastDataset.open(os.path.join(
            exp, "model_predictions", "forecast_chunked",
            "test_forecasts.zarr"))
        arr = np.stack([fc.variables[n][...] for n in fc.feature_order], -1)
        V = arr.shape[2]
        want = (fc.n_frt, CLI_AR_PREDICT + 1, V, F_DYN)
        rmse = np.asarray(gs["RMSE"])
        if (not losses or not np.isfinite(losses).all() or arr.shape != want
                or not np.isfinite(arr).all() or not np.isfinite(rmse).all()
                or not os.path.exists(os.path.join(
                    exp, "model_skills", "deterministic_global_skill.npz"))):
            raise AssertionError(f"{GRIDS_CLI} CLI: losses finite "
                                 f"{np.isfinite(losses).all()}, store "
                                 f"{arr.shape} (want {want}), RMSE {rmse}")
        log("grids400", f"{GRIDS_CLI} through cli.train_predict.main (bf16, "
                        f"{GRIDS_CLI_EPOCHS} epoch, toy O24 data of "
                        f"{GRIDS_CLI_STEPS} six-hour steps, {t_data:.1f} s): "
                        f"{rec['train_steps']} updates, losses finite, "
                        f"forecast store {arr.shape} finite, RMSE lead 1 "
                        f"{np.round(rmse[1], 4).tolist()} lead "
                        f"{CLI_AR_PREDICT} "
                        f"{np.round(rmse[CLI_AR_PREDICT], 4).tolist()}; "
                        f"{KERNEL} launches {parts}; main {t_main:.1f} s")

        art = os.path.join(root, "artifact")
        t0 = time.perf_counter()
        export_main(exp, data, out=art, batch_size=BATCH, block_size=BLOCK,
                    verbose=False, device=device)
        t_export = time.perf_counter() - t0
        with _RefuseGeometry():
            svc = ForecastService.from_dir(art)
        hist, bc = _serve_inputs(data, svc.meta, BATCH, BLOCK, SEED + 34)
        reset_launch_counts()
        first = svc.predict(hist, BLOCK, bc)
        served = launch_counts[KERNEL]
        svc.close()
        datasets = open_datasets(data)
        _, model = load_experiment_model(exp, datasets, device)
        meta = svc.meta
        rollout, _ = make_rollout_block(model, ARIndexer.build(
            meta["input_k"], meta["output_k"], meta["forecast_cycle"], 1),
            BLOCK)
        bc0 = bc if svc.scaler_bc is None else svc.scaler_bc.transform(bc)
        with torch.inference_mode():
            _, _, ref = rollout(
                torch.from_numpy(svc.scaler.transform(hist).astype(
                    np.float32)).to(device), None,
                torch.from_numpy(bc0.astype(np.float32)).to(device),
                torch.from_numpy(datasets[2].read_stacked()).to(device))
        ref = ref.float().cpu().numpy()
        e1 = rel_err(svc.scaler.transform(first)[:, 0], ref[:, 0])
        if (not e1 <= BARS["bf16"] or served != LAUNCHES_PER_FORWARD * BLOCK
                or not np.isfinite(first).all()):
            raise AssertionError(f"{GRIDS_CLI} artifact: step 1 vs the "
                                 f"in-process rollout {e1:.3e}, {served} "
                                 "launches")
        log("grids400", f"{GRIDS_CLI}: cli.export_model {t_export:.1f} s; "
                        f"the artifact, loaded with the geometry builder "
                        f"refused, forecasts {first.shape} finite, step 1 vs "
                        f"the in-process rollout of the same weights "
                        f"{e1:.3e} (bar {BARS['bf16']}), {served} {KERNEL} "
                        f"launches for {BLOCK} steps ({card_line})")
        fwd = (parts["train_forward"] + parts["validation"] + parts["predict"]
               + served)
        return {"launches": (fwd, parts["train_backward"]), "parts": parts,
                "seconds": time.perf_counter() - t_cli}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def grids_variants(device, card_line):
    """Each variant architecture: one bf16 forward and backward, the graph
    variants at HEALPix-16 (K1 at level 0), ConvNetSpherical at
    Equiangular_400km with conv_type='image'; finite, and exactly the
    level-0 K1 launches their blocks give (`VARIANTS`)."""
    import torch

    from deepsphere_weather_torch.models import get_model
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    out = {}
    for arch, (per_fwd, no_grad) in VARIANTS.items():
        if arch == "ConvNetSpherical":
            sampling, kw = "equiangular", {"nlat": 36, "nlon": 72}
            extra = {"conv_type": "image"}
        else:
            sampling = "healpix"
            kw = {"subdivisions": SLICE_SUBDIV, "nest": True}
            extra = {"knn": KNN}
        n = 12 * SLICE_SUBDIV ** 2 if sampling == "healpix" else 36 * 72
        info = tensor_info(n)
        if arch == "DownscalingNetSpherical":
            info["input_shape_info"] = {"dynamic": {"node": n // 4}}
        model = get_model(arch, info, sampling=sampling, sampling_kwargs=kw,
                          numeric_precision="bfloat16", device=device,
                          **extra).train()
        model.load_state_dict(train_params(model, SEED + 40))
        n_in = info["input_shape_info"]["dynamic"]["node"]
        x = torch.from_numpy(np.random.default_rng(SEED + 41).standard_normal(
            (BATCH, len(INPUT_K), n_in, F_STATIC + F_BC + F_DYN)).astype(
                np.float32)).to(device)
        torch.cuda.synchronize()
        reset_launch_counts()
        y = model(x)
        fwd = launch_counts[KERNEL]
        (y.float() ** 2).mean().backward()
        torch.cuda.synchronize()
        bwd = launch_counts[KERNEL] - fwd
        grads_finite = all(bool(torch.isfinite(p.grad).all())
                           for p in model.parameters())
        if (y.shape != (BATCH, 1, n, F_DYN) or not bool(torch.isfinite(y).all())
                or not grads_finite or (fwd, bwd) != (per_fwd,
                                                     per_fwd - no_grad)
                or sum(launch_counts.values()) != fwd + bwd):
            raise AssertionError(f"{arch}: output {tuple(y.shape)} finite "
                                 f"{bool(torch.isfinite(y).all())}, gradients "
                                 f"finite {grads_finite}, launches "
                                 f"{dict(launch_counts)}; want {per_fwd} + "
                                 f"{per_fwd - no_grad} {KERNEL}")
        log("grids400", f"{arch} ({sampling} {kw}, {extra}): bf16 forward "
                        f"{tuple(y.shape)} and backward finite, {fwd} + {bwd} "
                        f"{KERNEL} launches ({card_line})")
        out[f"grids400_{arch}"] = (fwd, bwd)
    return out


def grids_determinism(device, card_line):
    """The remap pools under the configs' `deterministic_training`: the
    MaxVal pool and unpool (`scatter_add`, where two destinations that
    chose one source add up) and the interp pool and unpool (whose
    backward accumulates), O24 level 0 -> 1, bf16, batch 16, 128
    channels, 6 repeats of the forward and backward without and with
    `torch.use_deterministic_algorithms`. With it, outputs and input
    gradients must repeat bitwise; without it, what they do is printed."""
    import torch

    from deepsphere_weather_torch.ops.pool import build_pool_unpool
    from deepsphere_weather_torch.sphere import build_sampling

    src = build_sampling("gauss", {"nlat": 48, "nlon": "ecmwf-octahedral"})
    dst = build_sampling("gauss", {"nlat": 24, "nlon": "ecmwf-octahedral"})
    rng = np.random.default_rng(SEED + 35)
    x0, g = (torch.from_numpy(rng.standard_normal(
        (BATCH, src.n_nodes, 128)).astype(np.float32)).to(
            device, torch.bfloat16) for _ in range(2))
    out = {}
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic)
        try:
            for method in ("maxval", "interp"):
                pool, unpool = build_pool_unpool(method, src, dst,
                                                 device=device)
                runs = []
                for _ in range(6):
                    x = x0.clone().requires_grad_()
                    y, idx = pool(x)
                    z = unpool(y, idx)
                    z.backward(g)
                    runs.append((z.detach(), x.grad))
                out[(method, deterministic)] = (
                    all(torch.equal(z, runs[0][0]) for z, _ in runs),
                    all(torch.equal(gx, runs[0][1]) for _, gx in runs))
                if idx is not None:
                    repeated = int(((idx[:, :, None, :] == idx[:, None, :, :])
                                    .sum(2) > 1).sum())
        finally:
            torch.use_deterministic_algorithms(False)
    log("grids400", "remap pools repeated 6 times (outputs, input gradients "
                    "bitwise equal): " + ", ".join(
                        f"{m} {'with' if d else 'without'} deterministic "
                        f"algorithms {v}" for (m, d), v in out.items())
                    + f"; {repeated} repeated MaxVal indices ({card_line})")
    if not all(v == (True, True) for (_, d), v in out.items() if d):
        raise AssertionError(f"a remap pool does not repeat under "
                             f"deterministic algorithms: {out}")


@clocked
def phase_grids400(device, card_line):
    """grids400 (module docstring): the six configurations, the O24 CLI
    run and the variants. Returns K1's launches by path and the readings."""
    t_phase = time.perf_counter()
    launches, figs, rows = {}, {}, None
    for i, name in enumerate(GRIDS400):
        r = grids_config(device, name, i, card_line)
        launches[f"grids400_{name}"] = (r["train"][0] + r["forecast"][0],
                                        r["train"][1])
        figs[name] = {k: r[k] for k in ("step_ms", "forecast_ms",
                                        "geometry_s", "seconds")}
        rows = r["rows"] or rows
    grids_determinism(device, card_line)
    cli = grids_cli(device, card_line)
    launches[f"grids400_{GRIDS_CLI}_cli"] = cli["launches"]
    launches.update(grids_variants(device, card_line))
    geom_s = sum(f["geometry_s"] for f in figs.values())
    total = time.perf_counter() - t_phase
    log("grids400", f"phase {total:.1f} s: geometry (host) {geom_s:.1f} s, "
                    f"the rest (device steps, checks, exports, the CLI) "
                    f"{total - geom_s:.1f} s; per config "
                    + ", ".join(f"{k} {v['seconds']:.1f} s"
                                for k, v in figs.items())
                    + f"; CLI {cli['seconds']:.1f} s ({card_line})")
    return {"launches": launches, "figs": figs, "rows": rows,
            "cli_parts": cli["parts"]}


# ---------------------------------------------------------------------------
# remat16, prep16, cli2rank, profile16, ensemble16: remat in member steps,
# the data-preparation CLIs, the CLI on a 2-rank mesh, the profiling
# harness and the DeepEnsemble sweep
# ---------------------------------------------------------------------------

def _remat_launches(remat):
    """K1 launches of one flagship member step (AR6): every forward
    product once, once more in the recompute with remat, and the
    backward's (but the first convolution's on the raw input)."""
    per_fwd = LAUNCHES_PER_FORWARD * (TRAIN_AR + 1)
    return per_fwd * (2 if remat else 1) + per_fwd - NO_GRAD_PRODUCTS


@clocked
def phase_remat16(device, card_line):
    """remat16: ens16's 2-member flagship step (bf16, AR6, batch 16; its
    weights and batch) with `remat=True` beside the same step without:
    exactly the K1 launches `_remat_launches` gives (the recompute runs
    every forward product again) and no other kernel, the losses of both,
    peak device memory over one step of each (after a first step) beside
    the single model's AR6 step's (member 0's weights): the member step's
    own peak at most MEMBER_PEAK_BAR of the single step's, and with remat
    at most REMAT_PEAK_BAR of itself without; step time (`time_steps`, in
    turns); then the fp32 batch-2 member step with
    and without remat (level 0 block-sparse: the ELL kernel): the remat
    run takes the plain run's ReLU and max-pool decisions (recorded by
    `steer`, forward and recompute, every one equal), losses and every
    gradient within REMAT_TOL."""
    import torch

    from deepsphere_weather_torch.engine import (
        Adam,
        make_member_train_step,
        make_train_step,
    )
    from deepsphere_weather_torch.models import MemberStack
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    t_phase = time.perf_counter()
    model = build_flagship(device, SLICE_SUBDIV).train()
    members = [train_params(model, SEED + 30 + m) for m in range(ENS_MEMBERS)]
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, BATCH, device, SEED + 32)
    steps, res = {}, {}
    # the memory allocated as each model call of a step returns: what the
    # step keeps for its backward grows with it (the forward hook fires
    # under functional_call, in the recompute too)
    at_call = []
    hook = model.register_forward_hook(
        lambda *_: at_call.append(torch.cuda.memory_allocated()))
    for remat in (False, True):
        stack = MemberStack.from_states(model, members)
        opt = Adam(stack.parameters(), lr=LR, member_axis=True)
        step = make_member_train_step(stack, indexer, opt, TRAIN_AR + 1,
                                      remat=remat)
        torch.cuda.synchronize()
        reset_launch_counts()
        total, per_iter = step(data, w, area_w)
        torch.cuda.synchronize()
        launches = dict(launch_counts)
        want = _remat_launches(remat)
        if launches[KERNEL] != want or sum(launches.values()) != want:
            raise AssertionError(f"remat16 remat={remat}: launches "
                                 f"{launches}, want {want} {KERNEL}")
        at_call.clear()
        base, peak = _peak_over(lambda: step(data, w, area_w))
        kept = max(at_call[:TRAIN_AR + 1]) - base
        res[remat] = {"per_iter": per_iter.float().cpu().numpy(),
                      "launches": want, "peak_gib": peak / 2 ** 30,
                      "step_gib": (peak - base) / 2 ** 30,
                      "kept_gib": kept / 2 ** 30}
        if not np.isfinite(res[remat]["per_iter"]).all():
            raise AssertionError(f"remat16 losses {res[remat]['per_iter']}")
        steps["remat16 member step" + (" with remat" if remat else "")] = (
            lambda step=step: step(data, w, area_w))
    hook.remove()
    model.load_state_dict(members[0])
    single = make_train_step(model, indexer,
                             Adam(model.parameters(), lr=LR), TRAIN_AR + 1)
    single(data, w, area_w)
    torch.cuda.synchronize()
    base, peak = _peak_over(lambda: single(data, w, area_w))
    single_gib = (peak - base) / 2 ** 30
    del single
    log("remat16", f"peak device memory over one AR{TRAIN_AR} batch {BATCH} "
                   f"bf16 step (after a first), past the step's start: the "
                   f"single model {single_gib:.3f} GiB, {ENS_MEMBERS} members "
                   f"{res[False]['step_gib']:.3f} GiB "
                   f"({res[False]['step_gib'] / single_gib:.2f}x, bar "
                   f"{MEMBER_PEAK_BAR}), {ENS_MEMBERS} members with remat "
                   f"{res[True]['step_gib']:.3f} GiB "
                   f"({res[True]['step_gib'] / res[False]['step_gib']:.2f}x "
                   f"of the member step without, bar {REMAT_PEAK_BAR}) "
                   f"({card_line})")
    if not (res[False]["step_gib"] <= MEMBER_PEAK_BAR * single_gib
            and res[True]["step_gib"]
            <= REMAT_PEAK_BAR * res[False]["step_gib"]):
        raise AssertionError(
            f"remat16 peaks: single {single_gib:.3f} GiB, members "
            f"{res[False]['step_gib']:.3f} GiB (bar {MEMBER_PEAK_BAR}x the "
            f"single's), with remat {res[True]['step_gib']:.3f} GiB (bar "
            f"{REMAT_PEAK_BAR}x the members' without)")
    ms = time_steps(steps, BATCH, card_line, REMAT_WINDOWS, SMOKE_STEPS)
    plain_ms, remat_ms = ms.values()
    e_bf16 = rel_err(res[True]["per_iter"], res[False]["per_iter"])
    log("remat16", f"{ENS_MEMBERS}-member step, HEALPix-{SLICE_SUBDIV} "
                   f"AR{TRAIN_AR} batch {BATCH} bf16: {KERNEL} launches "
                   f"{res[False]['launches']} without remat, "
                   f"{res[True]['launches']} with (the recompute's "
                   f"{LAUNCHES_PER_FORWARD * (TRAIN_AR + 1)} more), no other "
                   f"kernel; first-step losses with vs without {e_bf16:.3e}; "
                   f"peak device memory {res[False]['peak_gib']:.3f} -> "
                   f"{res[True]['peak_gib']:.3f} GiB (the step's own "
                   f"{res[False]['step_gib']:.3f} -> "
                   f"{res[True]['step_gib']:.3f} GiB, "
                   f"{res[True]['step_gib'] / res[False]['step_gib']:.2f}x), "
                   f"allocated past the step's start as its forward's "
                   f"{TRAIN_AR + 1} model calls return: at most "
                   f"{res[False]['kept_gib']:.3f} -> "
                   f"{res[True]['kept_gib']:.3f} GiB; "
                   f"step {plain_ms:.2f} -> {remat_ms:.2f} ms "
                   f"({remat_ms / plain_ms:.2f}x) ({card_line})")

    # fp32 batch 2: remat against the plain member step, same decisions
    fp32 = [train_params(model, SEED + 33 + m) for m in range(ENS_MEMBERS)]
    plain = _fp32_step(device, None, SEED + 35, members=fp32)
    rem = _fp32_step(device, None, SEED + 35, members=fp32, remat=True)
    n = len(plain["decisions"])
    per_call = n // (TRAIN_AR + 1)
    # the remat run records its forward's decisions, then the recompute's,
    # iteration by iteration from the last
    recompute = [d for i in reversed(range(TRAIN_AR + 1))
                 for d in plain["decisions"][i * per_call:(i + 1) * per_call]]
    differ = [i for i, (a, b) in enumerate(zip(
        rem["decisions"], plain["decisions"] + recompute))
        if not torch.equal(a, b)]
    if len(rem["decisions"]) != 2 * n or differ:
        raise AssertionError(f"remat16 fp32: {len(rem['decisions'])} "
                             f"decisions (want {2 * n}), {len(differ)} "
                             f"differ from the plain step's")
    e_loss = rel_err(rem["per_iter"].numpy(), plain["per_iter"].numpy())
    top = max(float(r.abs().max()) for r in plain["grads"].values())
    e_grad, key = grads_close(
        rem["grads"], plain["grads"],
        {k: top for k, r in plain["grads"].items() if r[0].numel() == 1},
        REMAT_TOL, "remat16 fp32 member step with vs without remat")
    if not e_loss <= REMAT_TOL:
        raise AssertionError(f"remat16 fp32 losses {e_loss:.3e}")
    log("remat16", f"fp32 batch {TRAIN_CHECK_BATCH} member step with vs "
                   f"without remat, on the same {n} ReLU and max-pool "
                   f"decisions (forward and recompute, every one equal): "
                   f"losses {e_loss:.3e}, gradients {e_grad:.3e} ({key}) "
                   f"(bar {REMAT_TOL:g}); phase "
                   f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"remat16_train": (
                2 * LAUNCHES_PER_FORWARD * (TRAIN_AR + 1),
                LAUNCHES_PER_FORWARD * (TRAIN_AR + 1) - NO_GRAD_PRODUCTS)},
            "ms": {"plain": plain_ms, "remat": remat_ms},
            "peak_gib": {k: v["peak_gib"] for k, v in res.items()},
            "step_gib": {"single": single_gib,
                         **{k: v["step_gib"] for k, v in res.items()}},
            "kept_gib": {k: v["kept_gib"] for k, v in res.items()}}


def _peak_over(run):
    """(bytes allocated before run(), the allocator's peak over it). The
    allocator's cache is kept (`run_train`: a step after
    torch.cuda.empty_cache() maps its memory again)."""
    import torch

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return base, torch.cuda.max_memory_allocated()


def _check_remat_ranks(ranks, plain, ref):
    """remat16's mesh check, inside ensmesh16's spawn: the 1 x 2 x 2 member
    step with remat (2 steps) against the same ranks' step without (its
    launches, gathers and losses) and the single-process member step.
    Returns the (forward and recompute, backward) K2 launches over the
    ranks."""
    want = _remat_launches(True)
    calls = 2 * (TRAIN_AR + 1)
    worst = 0.0
    for r, p in zip(ranks, plain):
        where = f"1 x 2 x 2 rank {r['mesh']} members {r['members']}"
        for i, (fwd, bwd) in enumerate(r["per_step"]):
            total = {k: fwd[k] + bwd[k] for k in fwd}
            if total[ROW_KERNEL] != want or sum(total.values()) != want:
                raise AssertionError(f"remat16 {where} step {i}: launches "
                                     f"{total}, want {want} {ROW_KERNEL}")
        if any(gs != [GATHERS_PER_FORWARD] * calls for gs in r["gathers"]):
            raise AssertionError(f"remat16 {where}: gathers {r['gathers']}")
        e = rel_err(r["per_iter"], ref[:len(r["per_iter"])])
        e_plain = rel_err(r["per_iter"], p["per_iter"][:len(r["per_iter"])])
        worst = max(worst, e_plain)
        if not (e <= SLICE_TOL and e_plain <= SLICE_TOL):
            raise AssertionError(f"remat16 {where}: losses vs one process "
                                 f"{e:.3e}, vs the step without remat "
                                 f"{e_plain:.3e}")
    ms = _mesh_ms(ranks)
    log("remat16", f"1 x 2 x 2 member mesh (4 ranks sharing the card over "
                   f"gloo), with remat: {want} {ROW_KERNEL} launches a step "
                   f"on each rank, {GATHERS_PER_FORWARD} gathers in each of "
                   f"{calls} model calls (forward and recompute); losses vs "
                   f"the same ranks without remat {worst:.3e} (bar "
                   f"{SLICE_TOL}); step {ms:.2f} ms vs ensmesh16's "
                   f"{_mesh_ms(plain):.2f} ms without (host clock, the slower "
                   f"rank; not a scaling number)")
    n = sum(len(r["per_step"]) for r in ranks)
    per_fwd = LAUNCHES_PER_FORWARD * (TRAIN_AR + 1)
    return 2 * per_fwd * n, (per_fwd - NO_GRAD_PRODUCTS) * n


@clocked
def phase_prep16(card_line):
    """prep16: an experiment's data and configs built from nothing by the
    port's data-preparation CLIs: `prepare_toy_data` (HEALPix-16, the
    flagship's features: 1460 six-hour steps, seed SEED, and its global
    scalers), `compute_scalers` (the scaler and climatology family),
    `compute_benchmarks` (persistence and climatology skills)
    and `create_configs` (the 108-file grid, each equal to the shipped
    config of its name); the benchmarks at PREP_LEADS leads. Host only. Returns the temporary directory (the
    caller removes it), the data directory, the generated flagship config
    and the seconds of each stage."""
    from deepsphere_weather_torch.cli import (
        compute_benchmarks,
        compute_scalers,
        create_configs,
        prepare_toy_data,
    )
    from deepsphere_weather_torch.verif import SkillDataset

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="dsw_prep16_")
    try:
        data = os.path.join(root, "data")
        secs = {}
        stages = [
            ("prepare_toy_data", lambda: prepare_toy_data.main(
                data, subdivisions=SLICE_SUBDIV, seed=SEED, verbose=False)),
            ("compute_scalers", lambda: compute_scalers.main(
                data, verbose=False)),
            ("compute_benchmarks", lambda: compute_benchmarks.main(
                data, n_leadtimes=PREP_LEADS, verbose=False)),
            ("create_configs", lambda: create_configs.create_configs(
                os.path.join(root, "configs")))]
        for name, run in stages:
            t0 = time.perf_counter()
            out = run()
            secs[name] = time.perf_counter() - t0
        n_cfg = out
        made = sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(os.path.join(root, "configs"))
                      for f in fs)
        shipped = sorted(os.path.relpath(os.path.join(d, f), here)
                         for d, _, fs in os.walk(os.path.join(here, "configs"))
                         for f in fs if f.endswith(".json"))
        if n_cfg != 108 or made != shipped:
            raise AssertionError(f"prep16: create_configs wrote {n_cfg} "
                                 f"files, {len(made)} of the shipped "
                                 f"{len(shipped)} names")
        for rel in made:
            with open(os.path.join(root, rel)) as f, \
                    open(os.path.join(here, rel)) as g:
                if json.load(f) != json.load(g):
                    raise AssertionError(f"prep16: {rel} differs from the "
                                         "shipped config")
        files = {}
        for sub in ("Data", "Scalers", "Climatology", "Benchmarks"):
            top = os.path.join(data, sub)
            names = [os.path.join(d, f) for d, _, fs in os.walk(top)
                     for f in fs]
            files[sub] = (len(names), sum(os.path.getsize(p) for p in names))
        bench = SkillDataset.load(os.path.join(
            data, "Benchmarks", "Persistence_Global_Skills.npz"))
        rmse = np.asarray(bench["RMSE"])
        if not (np.isfinite(rmse).all() and (rmse[-1] > rmse[0]).all()):
            raise AssertionError(f"prep16: persistence RMSE {rmse}")
        log("prep16", "seconds: " + ", ".join(
            f"{k} {v:.1f}" for k, v in secs.items())
            + f"; files written under data/: " + ", ".join(
                f"{k} {n} ({b / 2 ** 20:.1f} MiB)"
                for k, (n, b) in files.items())
            + f"; configs/: {n_cfg}, each equal to the shipped config of its "
              f"name; persistence RMSE lead 1 "
              f"{np.round(rmse[0], 3).tolist()} -> lead {len(rmse)} "
              f"{np.round(rmse[-1], 3).tolist()} (host only)")
        return {"root": root, "data": data, "seconds": secs,
                "config": os.path.join(root, PROTOCOL_CONFIG)}
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


def _short_config(prep, **training):
    """prep16's flagship config cut to a short run: bf16, one epoch,
    AR1 training, the short periods of CLI_PERIODS, scored every
    CLI_SCORING updates; `training` overrides more."""
    with open(prep["config"]) as f:
        cfg = json.load(f)
    cfg["training_settings"].update(numeric_precision="bfloat16", epochs=1,
                                    scoring_interval=CLI_SCORING,
                                    **CLI_PERIODS, **training)
    cfg["ar_settings"]["ar_iterations"] = 1
    return cfg


def _write_log(path):
    """The write log of tests/write_log_site/sitecustomize.py: (writes
    [(pid, time, path)], launches {pid: {kernel: n}})."""
    writes, launches = [], {}
    with open(path) as f:
        for line in f:
            pid, t, text = line.rstrip("\n").split(" ", 2)
            if text.startswith("launches "):
                launches[int(pid)] = json.loads(text[len("launches "):])
            else:
                writes.append((int(pid), float(t), text))
    return writes, launches


@clocked
def phase_cli2rank(device, card_line, prep):
    """cli2rank: `python -m deepsphere_weather_torch.cli.train_predict` on
    prep16's data with the flagship config at `n_node_parallel: 2` (cut
    by `_short_config`), started as a user starts it: the CLI spawns its
    2 ranks (they share the card over gloo), each trains its half of the
    sphere (K2), rank 0 alone predicts on the whole geometry (K1),
    rechunks, verifies and writes. Against the same config on one process
    (`main`, in this process): the scored losses within SLICE_TOL, rank
    0's RMSE within RMSE_TOL, the forecast stores finite and of one
    shape; every output written once, all by rank 0 (the write log of
    tests/write_log_site/sitecustomize.py, with each process's launch
    counters); wall seconds by stage from the log's times."""
    import torch

    from deepsphere_weather_torch.cli.train_predict import main as train_main
    from deepsphere_weather_torch.engine.prediction import ForecastDataset
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(prep["root"], "cli2rank")
    os.makedirs(root)
    paths = {}
    for tag, n_node in (("one", 1), ("two", 2)):
        cfg = _short_config(prep, n_node_parallel=n_node)
        paths[tag] = os.path.join(root, f"{tag}.json")
        with open(paths[tag], "w") as f:
            json.dump(cfg, f)
    wlog = os.path.join(root, "writes.log")
    env = dict(os.environ, DSW_WRITE_LOG=wlog, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "tests", "write_log_site"), here]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "deepsphere_weather_torch.cli.train_predict",
         "--config_file", paths["two"], "--data_dir", prep["data"],
         "--exp_dir", os.path.join(root, "exp_two"), "--force",
         "--ar_iterations_prediction", str(CLI_AR_PREDICT)],
        cwd=here, env=env, capture_output=True, text=True,
        timeout=RANKS_LIMIT_S)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli2rank: rc {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    launch_line = [ln for ln in proc.stdout.splitlines()
                   if ln.startswith("launch: ")]
    reset_launch_counts()
    t1 = time.perf_counter()
    try:
        exp1, gs1 = train_main(paths["one"], prep["data"],
                               os.path.join(root, "exp_one"), force=True,
                               ar_iterations_prediction=CLI_AR_PREDICT,
                               device=device, verbose=False)
    finally:
        torch.use_deterministic_algorithms(False)
    one_s = time.perf_counter() - t1
    one_launches = dict(launch_counts)
    exp2 = os.path.join(root, "exp_two", os.path.basename(str(exp1)))

    writes, launches = _write_log(wlog)
    written = [p for _, _, p in writes]
    writers = {pid for pid, _, _ in writes}
    # the CLI, its 2 ranks and multiprocessing's resource tracker
    if (len(launch_line) != 1 or len(launches) < 3 or len(writers) != 1
            or len(written) != len(set(written))):
        raise AssertionError(f"cli2rank: launch lines {launch_line}, "
                             f"{len(launches)} processes, writers {writers}, "
                             f"{len(written)} writes of "
                             f"{len(set(written))} paths")
    rank0 = writers.pop()
    ranks = [pid for pid in launches if launches[pid][ROW_KERNEL]]
    if (len(ranks) != 2 or rank0 not in ranks
            or launches[rank0][KERNEL] == 0
            or any(launches[p][KERNEL] for p in ranks if p != rank0)
            or any(sum(launches[p].values()) != launches[p][ROW_KERNEL]
                   + launches[p][KERNEL] for p in ranks)):
        raise AssertionError(f"cli2rank: launches by process {launches} "
                             f"(rank 0 {rank0})")
    losses = []
    for exp in (str(exp1), exp2):
        with open(os.path.join(exp, "training_info",
                               "ar_training_info.json")) as f:
            info = json.load(f)
        losses.append(np.asarray(info["training_total_loss"]
                                 + info["validation_total_loss"]))
    e_loss = rel_err(losses[1], losses[0])
    stores = [ForecastDataset.open(os.path.join(
        e, "model_predictions", "forecast_chunked", "test_forecasts.zarr"))
        for e in (str(exp1), exp2)]
    arrs = [np.stack([s.variables[n][...] for n in s.feature_order], -1)
            for s in stores]
    from deepsphere_weather_torch.verif import SkillDataset

    rmse = np.asarray(SkillDataset.load(os.path.join(
        exp2, "model_skills", "deterministic_global_skill.npz"))["RMSE"])
    e_rmse = rel_err(rmse, np.asarray(gs1["RMSE"]))
    if (not losses[0].size or losses[0].shape != losses[1].shape
            or not e_loss <= SLICE_TOL or arrs[0].shape != arrs[1].shape
            or not np.isfinite(arrs[1]).all() or not e_rmse <= RMSE_TOL):
        raise AssertionError(f"cli2rank: losses {losses} ({e_loss:.3e}), "
                             f"stores {[a.shape for a in arrs]}, RMSE "
                             f"{e_rmse:.3e}")
    times = sorted(t for _, t, _ in writes)
    at = {os.path.relpath(p, exp2).split(os.sep)[0] + "/"
          + os.path.basename(p): t for _, t, p in writes}
    t_cfg = at.get("config.json/config.json", times[0])
    t_fc = min(t for _, t, p in writes if "forecast_chunked" in p)
    t_sp = min(t for _, t, p in writes if "space_chunked" in p)
    log("cli2rank", launch_line[0])
    log("cli2rank", f"flagship config, n_node_parallel 2, cut: bf16, 1 "
                    f"epoch, AR1, periods {CLI_PERIODS}, scored every "
                    f"{CLI_SCORING} updates, AR{CLI_AR_PREDICT} forecast of "
                    f"{stores[1].n_frt} reference times: rc 0; losses vs one "
                    f"process {e_loss:.3e} (bar {SLICE_TOL}), rank 0's RMSE "
                    f"{e_rmse:.3e} (bar {RMSE_TOL}); forecast store "
                    f"{arrs[1].shape} finite; {len(written)} outputs, each "
                    f"written once, all by rank 0 (pid {rank0})")
    log("cli2rank", f"launches by process: {launches} (rank 0 {rank0}: "
                    f"{ROW_KERNEL} in training, {KERNEL} in its prediction); "
                    f"one process: {one_launches}")
    log("cli2rank", f"wall seconds: 2 ranks {wall:.1f} (start, spawn, data "
                    f"and model to the config write {t_cfg - t0:.1f}, train "
                    f"{t_fc - t_cfg:.1f}, predict {t_sp - t_fc:.1f}, rechunk "
                    f"and verify {times[-1] - t_sp:.1f}, exit "
                    f"{t0 + wall - times[-1]:.1f}); one process in this "
                    f"process {one_s:.1f} ({card_line})")
    k2 = sum(launches[p][ROW_KERNEL] for p in ranks)
    return {"k2": k2, "k1": launches[rank0][KERNEL] + one_launches[KERNEL]}


def _trace_rows(path):
    """Device kernel rows of a Chrome trace: [(ms, count, name)], largest
    first."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rows = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            ms, n = rows.get(e["name"], (0.0, 0))
            rows[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return sorted(((ms, n, k) for k, (ms, n) in rows.items()), reverse=True)


@clocked
def phase_profile16(device, card_line):
    """profile16: the port's profiling harness on the card. `profile_step`
    of the flagship forward (bf16, batch 16, no gradient) and of its train
    step (AR6, batch 16), each with a torch.profiler Chrome trace: the
    top device rows by name; `summarize_model`'s total; then
    `scalability_sweep` (fp32, as the JAX sweep) over HEALPix-16 and -32
    at knn 8 and 20: forward and forward + backward ms against nodes,
    with exactly the ELL launches the sweep's block-sparse level (HEALPix-
    32 level 0) takes and no other kernel."""
    import torch

    from deepsphere_weather_torch.engine import Adam, make_train_step
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.utils.profiling import (
        profile_step,
        scalability_sweep,
        summarize_model,
    )

    t_phase = time.perf_counter()
    model = build_flagship(device, SLICE_SUBDIV,
                           train_params(build_flagship(device, SLICE_SUBDIV),
                                        SEED + 70)).train()
    total = summarize_model(model).splitlines()[-1].split()[1]
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, BATCH, device, SEED + 71)
    x = torch.from_numpy(np.random.default_rng(SEED + 72).standard_normal(
        (BATCH, len(INPUT_K), model.input_n_node, model.input_n_feature)
    ).astype(np.float32)).to(device)
    step = make_train_step(model, indexer, Adam(model.parameters(), lr=LR),
                           TRAIN_AR + 1)

    def forward(x):
        with torch.no_grad():
            return model(x)

    with tempfile.TemporaryDirectory() as tmp:
        for label, fn, args, n in (
                (f"forward, batch {BATCH}", forward, (x,), 10),
                (f"train step, AR{TRAIN_AR} batch {BATCH}", step,
                 (data, w, area_w), 4)):
            out = profile_step(fn, *args, n=n, warmup=1,
                               trace_dir=os.path.join(tmp, "t"))
            rows = _trace_rows(os.path.join(tmp, "t", "trace.json"))
            busy = sum(r[0] for r in rows)
            log("profile16", f"profile_step {label}: median "
                             f"{1e3 * out['median_s']:.3f} ms, p10 "
                             f"{1e3 * out['p10_s']:.3f}, p90 "
                             f"{1e3 * out['p90_s']:.3f} ({n} calls, host "
                             f"clock); traced call: {len(rows)} kernel "
                             f"names, {sum(r[1] for r in rows)} launches, "
                             f"device busy {busy:.3f} ms ({card_line})")
            for ms, count, name in rows[:PROFILE_TOP]:
                log("profile16", f"{100 * ms / max(busy, 1e-9):5.1f}%  "
                                 f"{ms:8.4f} ms  {count:4d}x  {name[:90]}")
    log("profile16", f"summarize_model: {total} parameters")
    torch.cuda.synchronize()
    reset_launch_counts()
    sweep = scalability_sweep(
        [{"sampling": "healpix", "sampling_kwargs": {"subdivisions": s,
                                                     "nest": True}}
         for s in SWEEP_SUBDIVS], knn_list=SWEEP_KNN, device=device)
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    # per (sampling, knn) with a block-sparse level 0: 12 forwards (2
    # warm) and 11 steps (1 warm), 10 products a forward, 8 backward (the
    # first convolution's input needs no gradient)
    sparse = [r for r in sweep if r["n_nodes"] > FP32_DENSE_LIMIT]
    want = len(sparse) * (12 * LAUNCHES_PER_FORWARD + 11 * (
        2 * LAUNCHES_PER_FORWARD - NO_GRAD_PRODUCTS))
    if (not sparse or launches[ELL_KERNEL] != want
            or sum(launches.values()) != want):
        raise AssertionError(f"profile16 sweep launches {launches}, want "
                             f"{want} {ELL_KERNEL}")
    for r in sweep:
        log("profile16", f"scalability_sweep fp32 batch 1: {r['n_nodes']} "
                         f"nodes, knn {r['knn']}: forward "
                         f"{r['forward_ms']:.3f} ms, forward + backward "
                         f"{r['forward_backward_ms']:.3f} ms ({card_line})")
    log("profile16", f"sweep: {want} {ELL_KERNEL} launches (level 0 of "
                     f"the {len(sparse)} block-sparse configurations), no "
                     f"other kernel; phase {time.perf_counter() - t_phase:.1f} "
                     "s")
    per = len(sparse)
    return {"launches": (per * (12 + 11) * LAUNCHES_PER_FORWARD,
                         per * 11 * (LAUNCHES_PER_FORWARD
                                     - NO_GRAD_PRODUCTS))}


@clocked
def phase_ensemble16(device, card_line, prep):
    """ensemble16: `cli.experiments.run_deep_ensemble` with 2 members in
    the member step (`member_parallel`), `remat: true`, on prep16's data
    with the flagship config cut by `_short_config`, an
    AR{CLI_AR_PREDICT} forecast: every member step recomputes each AR
    iteration it checkpoints (`torch.utils.checkpoint` in `engine.step`:
    each checkpointed iteration runs twice), only K1 launched, the
    ensemble and median stores finite, the median's RMSE and the
    ensemble's CRPS finite; seconds by stage."""
    import torch

    import deepsphere_weather_torch.engine as engine
    from deepsphere_weather_torch.cli import experiments
    from deepsphere_weather_torch.engine import step as step_mod
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    root = os.path.join(prep["root"], "ensemble16")
    os.makedirs(root)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(_short_config(prep, remat=True), f)
    secs, checkpoints, runs = {}, [0], [0]
    trainer, members, checkpoint = (engine.AutoregressiveTraining,
                                    experiments._train_members_parallel,
                                    step_mod.checkpoint)

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                secs[name] = time.perf_counter() - t0
        return run

    def counted(fn, *a, **k):
        checkpoints[0] += 1

        def run(*a, **k):
            runs[0] += 1
            return fn(*a, **k)
        return checkpoint(run, *a, **k)

    engine.AutoregressiveTraining = timed("train", trainer)
    experiments._train_members_parallel = timed("members", members)
    step_mod.checkpoint = counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = experiments.run_deep_ensemble(
            cfg_path, prep["data"], os.path.join(root, "exp"),
            n_members=ENS_MEMBERS, ar_iterations_prediction=CLI_AR_PREDICT,
            member_parallel=True, device=device)
    finally:
        engine.AutoregressiveTraining = trainer
        experiments._train_members_parallel = members
        step_mod.checkpoint = checkpoint
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    med = res["median"]
    arr = np.stack([med.variables[n][...] for n in med.feature_order], -1)
    rmse = np.asarray(res["global_skill"]["RMSE"])
    crps = np.asarray(res["probabilistic_skill"]["CRPS"])
    recomputed = runs[0] - checkpoints[0]
    if (not checkpoints[0] or recomputed != checkpoints[0]
            or launches[KERNEL] == 0
            or sum(launches.values()) != launches[KERNEL]
            or arr.shape[1:] != (CLI_AR_PREDICT + 1, 12 * SLICE_SUBDIV ** 2,
                                 F_DYN)
            or not np.isfinite(arr).all() or not np.isfinite(rmse).all()
            or not np.isfinite(crps).all()):
        raise AssertionError(f"ensemble16: {checkpoints[0]} checkpointed "
                             f"AR iterations, {recomputed} recomputed, "
                             f"launches {launches}, median "
                             f"{arr.shape}, RMSE {rmse}, CRPS {crps}")
    log("ensemble16", f"run_deep_ensemble, {ENS_MEMBERS} members in the "
                      f"member step with remat ({recomputed} AR "
                      f"iterations recomputed in the backward), flagship "
                      f"config cut as cli2rank's: median store "
                      f"{arr.shape} finite, RMSE lead 1 "
                      f"{np.round(rmse[1], 4).tolist()} -> lead "
                      f"{CLI_AR_PREDICT} {np.round(rmse[-1], 4).tolist()}, "
                      f"CRPS lead {CLI_AR_PREDICT} "
                      f"{np.round(crps[-1], 4).tolist()}; {launches[KERNEL]} "
                      f"{KERNEL} launches, no other kernel")
    log("ensemble16", f"wall seconds: {wall:.1f} (members trained "
                      f"{secs['train']:.1f}, member predictions "
                      f"{secs['members'] - secs['train']:.1f}, ensemble, "
                      f"median and verification "
                      f"{wall - secs['members']:.1f}) ({card_line})")
    return {"k1": launches[KERNEL]}


@clocked
def phase_xyear16(device, card_line, proto):
    """xyear16: `cli.experiments.run_x_year_simulations` of protocol16's
    resumed flagship (bf16, K1 at level 0) for XYEAR_YEARS years at its
    six-hour `forecast_cycle`, in the default blocks of 1000 steps (and
    the tail), from two reference times near the end of protocol16's
    store: the analytic TOA-solar generator forces every step past the
    store. Checks: every lead written and finite (none reads back as the
    fill value), K1 alone launched, 10 a model call, the generator called
    for every (reference time, step) the store does not cover, the
    device's peak over the run within XYEAR_MEM_TOL of its peak over the
    first block. Readings: seconds per step, the writer's share."""
    import torch

    import deepsphere_weather_torch.cli.common as common
    import deepsphere_weather_torch.data.toy as toy
    import deepsphere_weather_torch.data.zarrstore as zarrstore
    import deepsphere_weather_torch.engine as engine
    import deepsphere_weather_torch.engine.prediction as prediction
    from deepsphere_weather_torch.cli import experiments
    from deepsphere_weather_torch.data import SphericalDataset
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    t_phase = time.perf_counter()
    with open(os.path.join(proto["exp"], "config.json")) as f:
        ar = json.load(f)["ar_settings"]
    dyn = SphericalDataset.open(os.path.join(
        proto["data"], "Data", "dynamic", "time_chunked", "dynamic.zarr"))
    t0s = [dyn.n_time - k for k in XYEAR_FRTS]
    n_steps = int(round(XYEAR_YEARS * 365 * 24 / ar["forecast_cycle"])) + 1
    # the (reference time, step) pairs whose boundary conditions lie past
    # the store: the generator's
    lags = np.asarray(ar["input_k"])
    beyond = sum(int(t0 + j * ar["forecast_cycle"] + lags.max()
                     >= dyn.n_time) for t0 in t0s for j in range(n_steps))
    rec = {"forwards": 0, "blocks": [], "toa": 0, "writes": 0,
           "write_s": 0.0, "predict_s": 0.0}
    saved = []

    def patch(module, name, new):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    load = common.load_experiment_model

    def loaded(*a, **k):
        cfg, model = load(*a, **k)
        model.register_forward_hook(
            lambda *_: rec.__setitem__("forwards", rec["forwards"] + 1))
        return cfg, model

    make = prediction.make_rollout_block

    def make_block(*a, **k):
        fn, history = make(*a, **k)

        def block(*b):
            out = fn(*b)
            torch.cuda.synchronize()
            rec["blocks"].append((out[2].shape[1],
                                  torch.cuda.max_memory_allocated()))
            return out
        return block, history

    toa = toy.toa_solar_radiation

    def counted_toa(times, *a, **k):
        rec["toa"] += 1
        return toa(times, *a, **k)

    write_chunk = zarrstore.ZarrArray._write_chunk

    def timed_write(self, idx, data):
        t0 = time.perf_counter()
        write_chunk(self, idx, data)
        rec["writes"] += 1
        rec["write_s"] += time.perf_counter() - t0

    predictions = engine.AutoregressivePredictions

    def timed_predictions(*a, **k):
        t0 = time.perf_counter()
        out = predictions(*a, **k)
        rec["predict_s"] = time.perf_counter() - t0
        return out

    patch(common, "load_experiment_model", loaded)
    patch(prediction, "make_rollout_block", make_block)
    patch(toy, "toa_solar_radiation", counted_toa)
    patch(zarrstore.ZarrArray, "_write_chunk", timed_write)
    patch(engine, "AutoregressivePredictions", timed_predictions)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        fc = experiments.run_x_year_simulations(
            proto["exp"], proto["data"], years=XYEAR_YEARS,
            forecast_reference_times=[str(t) for t in dyn.time[t0s]],
            verbose=False, device=device)
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    arr = np.stack([fc.variables[v][...] for v in fc.feature_order], -1)
    # a lead no block wrote reads back as the fill value (0) everywhere
    unwritten = int((np.abs(arr).max(axis=(2, 3)) == 0).sum())
    finite = np.isfinite(arr).all(axis=(0, 2, 3))
    first_bad = None if finite.all() else int(np.argmin(finite))
    steps = [s for s, _ in rec["blocks"]]
    first_peak = rec["blocks"][0][1] if rec["blocks"] else 0
    want_blocks = [1000] * (n_steps // 1000) + (
        [n_steps % 1000] if n_steps % 1000 else [])
    log("xyear16", f"run_x_year_simulations, {XYEAR_YEARS} year(s) of the "
                   f"protocol16 flagship (bf16) at its {ar['forecast_cycle']}"
                   f" h forecast_cycle: {fc.n_frt} reference times x "
                   f"{fc.n_leadtime} leads in blocks {steps} (one batch), "
                   f"{rec['forwards']} model calls, launches "
                   f"{ {k: v for k, v in launches.items() if v} }; leads "
                   f"unwritten {unwritten}, first non-finite lead "
                   f"{first_bad}; TOA generator {rec['toa']} calls (the "
                   f"{beyond} reference-time steps past the store); peak "
                   f"device memory {peak / 2 ** 30:.3f} GiB over the run, "
                   f"{first_peak / 2 ** 30:.3f} GiB over the first block")
    if (fc.n_leadtime != n_steps or fc.n_frt != len(t0s)
            or steps != want_blocks or rec["forwards"] != n_steps
            or unwritten or first_bad is not None
            or launches[KERNEL] != LAUNCHES_PER_FORWARD * rec["forwards"]
            or sum(launches.values()) != launches[KERNEL]
            or rec["toa"] != beyond
            or peak > (1 + XYEAR_MEM_TOL) * first_peak):
        raise AssertionError(
            f"xyear16: {fc.n_frt} x {fc.n_leadtime} leads (want "
            f"{len(t0s)} x {n_steps}), blocks {steps} (want {want_blocks}), "
            f"{rec['forwards']} model calls, launches {launches}, "
            f"{unwritten} unwritten, first non-finite lead {first_bad}, "
            f"TOA {rec['toa']} (want {beyond}), peak {peak} vs first "
            f"block's {first_peak} (bar {1 + XYEAR_MEM_TOL}x)")
    log("xyear16", f"wall {wall:.1f} s, the rollout "
                   f"{rec['predict_s']:.1f} s: "
                   f"{1e3 * rec['predict_s'] / n_steps:.3f} ms a step (batch "
                   f"{fc.n_frt}); the writer thread's {rec['writes']} chunk "
                   f"writes {rec['write_s']:.1f} s, "
                   f"{100 * rec['write_s'] / rec['predict_s']:.1f}% of the "
                   f"rollout's wall; phase {time.perf_counter() - t_phase:.1f}"
                   f" s ({card_line})")
    return {"launches": (launches[KERNEL], 0),
            "ms_per_step": 1e3 * rec["predict_s"] / n_steps,
            "writer_share": rec["write_s"] / rec["predict_s"],
            "peak_gib": peak / 2 ** 30}


def _ingest_config():
    """The shipped flagship config cut as cli2rank's is (`_short_config`:
    bf16, 1 epoch, AR1, CLI_PERIODS, scored every CLI_SCORING updates),
    full width and depth."""
    here = os.path.dirname(os.path.abspath(__file__))
    return _short_config({"config": os.path.join(here, PROTOCOL_CONFIG)})


def _bulk_vs_chunks(paths):
    """Every array of the zarr groups at `paths` read whole by the native
    bulk reader and chunk by chunk in Python (the chunk cache bypassed):
    (exactly equal, bulk seconds, Python seconds, decompressed bytes,
    chunks)."""
    from deepsphere_weather_torch.data import zarrstore

    equal, t_bulk, t_py, n_bytes, n_chunks = True, 0.0, 0.0, 0, 0
    for path in paths:
        group = zarrstore.open_group(path)
        for name in group.array_names():
            arr = group[name]
            idxs = arr._chunks_overlapping(arr._norm_key(...)[0])
            t0 = time.perf_counter()
            bulk = [c for _, c in arr._read_chunks_uncached(idxs)]
            t1 = time.perf_counter()
            plain = [arr._read_chunk(i) for i in idxs]
            t2 = time.perf_counter()
            t_bulk += t1 - t0
            t_py += t2 - t1
            n_chunks += len(idxs)
            n_bytes += sum(c.nbytes for c in plain)
            equal &= all(np.array_equal(a, b) and a.dtype == b.dtype
                         for a, b in zip(bulk, plain))
    return equal, t_bulk, t_py, n_bytes, n_chunks


def ingest16_host():
    """ingest16's host stages (no device work): a GRIB2 tree in the reference's layout
    (`<dataset>/<native>/<type>/<var>/*.grib`, tests/torch_ingest_chain.py)
    on the O32 reduced Gaussian grid: z and t at 500 and 850 hPa and
    accumulated TOA solar radiation every 6 hours for INGEST_STEPS steps,
    and topography, land-sea mask and soil type; `remap_grib_files` onto
    the flagship's HEALPix-16 (conservative, soil type by largest area
    fraction; weights from the native library, no disk cache), reformat,
    `zarrify_raw_data`, `rechunk_to_space_chunked`, the statics,
    `cli.compute_scalers`. Checks: the native weights against the plain
    version on INGEST_PAIR (NATIVE_TOL), the ingested z500's area-weighted
    mean against the GRIB field's (CONSERVE_TOL), the native bulk reader
    against the per-chunk Python path on every ingested store (exactly).
    Returns the temporary directory (the caller removes it), the data
    directory, the config and the seconds of each stage."""
    from deepsphere_weather_torch.cli import compute_scalers
    from deepsphere_weather_torch.data import grib
    from deepsphere_weather_torch.data import preprocess as pp
    from deepsphere_weather_torch.data.dataset import save_static
    from deepsphere_weather_torch.native import build, geometry
    from deepsphere_weather_torch.sphere import build_sampling
    from deepsphere_weather_torch.sphere.remap import (
        _conservative_weights_numpy,
        area_weights,
    )
    from torch_ingest_chain import ingest, write_grib_tree

    t_host = time.perf_counter()
    cfg = _ingest_config()
    ms = cfg["model_settings"]
    dst = build_sampling(ms["sampling"], dict(ms["sampling_kwargs"]))
    grid = grib.GridSpec("reduced_gg", 2 * INGEST_O,
                         pl=grib.octahedral_pl(INGEST_O))
    native = f"O{INGEST_O}"
    root = tempfile.mkdtemp(prefix="dsw_ingest16_")
    secs = {}
    try:
        # both host libraries built (or loaded) before any stage is timed
        t0 = time.perf_counter()
        for lib in ("geometry", "chunkio"):
            build.load_library(lib)
        secs["native_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = write_grib_tree(grib, root, INGEST_DATASET, native, grid,
                               INGEST_STEPS, SEED)
        secs["grib_write"] = time.perf_counter() - t0

        (sname, nlat, o), (dname, dkw) = INGEST_PAIR
        small = (build_sampling(sname, {"nlat": nlat, "nlon": list(
            grib.octahedral_pl(o))}), build_sampling(dname, dkw))
        t0 = time.perf_counter()
        W, _, _ = geometry.conservative_weights(*small)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        Wp, _, _ = _conservative_weights_numpy(*small)
        t_plain = time.perf_counter() - t0
        e_native = float(abs(W - Wp).max())
        if not e_native <= NATIVE_TOL:
            raise AssertionError(f"ingest16: native weights vs plain "
                                 f"{e_native:.3e} (bar {NATIVE_TOL})")

        data = os.path.join(root, "data")
        registry = dict(pp.NATIVE_GRIDS)
        pp.NATIVE_GRIDS[INGEST_DATASET] = native
        try:
            out = ingest(pp, save_static, root, INGEST_DATASET,
                         INGEST_SAMPLING_NAME, dst, data, time_chunk=24 * 7)
        finally:
            pp.NATIVE_GRIDS.clear()
            pp.NATIVE_GRIDS.update(registry)
        secs.update(out["seconds"])
        w_src = area_weights(grid.to_sampling()).astype(np.float64)
        w_dst = area_weights(dst).astype(np.float64)
        with np.load(out["dynamic"][0]) as z:
            remapped = z["z"][0, 0].astype(np.float64)
        src = tree["fields"][(0, "z", 500)].astype(np.float64)
        m_src = float(w_src @ src / w_src.sum())
        m_dst = float(w_dst @ remapped / w_dst.sum())
        e_cons = abs(m_dst - m_src) / abs(m_src)
        if not e_cons < CONSERVE_TOL:
            raise AssertionError(f"ingest16: z500 mean {m_dst} vs GRIB "
                                 f"{m_src} ({e_cons:.3e}, bar "
                                 f"{CONSERVE_TOL})")
        t0 = time.perf_counter()
        compute_scalers.main(data, verbose=False)
        secs["compute_scalers"] = time.perf_counter() - t0

        stores = [os.path.join(data, "Data", *rel) for rel in (
            ("dynamic", "time_chunked", "dynamic.zarr"),
            ("dynamic", "space_chunked", "dynamic.zarr"),
            ("bc", "time_chunked", "bc.zarr"))]
        equal, t_bulk, t_py, n_read, n_chunks = _bulk_vs_chunks(stores)
        if not equal:
            raise AssertionError("ingest16: the native bulk reader differs "
                                 "from the per-chunk Python path")
        secs["host"] = time.perf_counter() - t_host
        log("ingest16", f"GRIB2 tree O{INGEST_O} ({grid.n_points} points, "
                        f"{INGEST_STEPS} six-hour steps, z and t at 500 "
                        f"and 850 hPa, tisr, 3 statics): {tree['files']} "
                        f"files, {tree['bytes']} bytes")
        log("ingest16", f"native weights vs plain on O{o} -> "
                        f"HEALPix-{dkw['subdivisions']}: {e_native:.3e} "
                        f"(bar {NATIVE_TOL}; native {t_native:.2f} s, "
                        f"plain {t_plain:.2f} s, host); z500 area-weighted "
                        f"mean ingested {m_dst:.3f} vs GRIB {m_src:.3f}: "
                        f"{e_cons:.3e} (bar {CONSERVE_TOL})")
        log("ingest16", f"bulk reader vs per-chunk Python on the 3 "
                        f"ingested stores: equal exactly, {n_chunks} "
                        f"chunks, {n_read} bytes; bulk {t_bulk:.4f} s, "
                        f"Python {t_py:.4f} s (host)")
        return {"root": root, "data": data, "config": cfg, "seconds": secs}
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


@clocked
def phase_ingest16(device, card_line, host):
    """ingest16: raw GRIB2 to a trained and verified experiment through the
    port's entry points: `host`, `ingest16_host()`'s data directory (the
    GRIB tree remapped, ingested and scaled on the host; run beside the
    rank phases), then `cli.train_predict.main` with
    the flagship config cut as cli2rank's (bf16, full width and depth, K1
    at level 0), AR4 forecast, verification and the plots (or the
    driver's skip line). Checks: K1 launched in the run and no other
    kernel, finite losses and RMSE, the figures or the skip line. Seconds
    by stage."""
    import contextlib
    import io

    import torch

    from deepsphere_weather_torch.cli.train_predict import main as train_main
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    t_phase = time.perf_counter()
    res = host
    root, data, secs = res["root"], res["data"], res["seconds"]
    try:
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(res["config"], f)
        torch.cuda.synchronize()
        reset_launch_counts()
        text = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(text):
                exp, gs = train_main(
                    cfg_path, data, os.path.join(root, "exp"), force=True,
                    ar_iterations_prediction=CLI_AR_PREDICT, device=device)
        except BaseException:
            print(text.getvalue()[-3000:])
            raise
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.synchronize()
        secs["train_predict"] = time.perf_counter() - t0
        launches = dict(launch_counts)
        lines = text.getvalue().splitlines()
        with open(os.path.join(exp, "training_info",
                               "ar_training_info.json")) as f:
            info = json.load(f)
        losses = np.asarray(info["training_total_loss"]
                            + info["validation_total_loss"])
        rmse = np.asarray(gs["RMSE"])
        figs = sorted(os.path.relpath(os.path.join(d, f), exp)
                      for d, _, fs in os.walk(os.path.join(exp, "figs"))
                      for f in fs)
        skipped = "plots skipped: matplotlib is not installed" in lines
        if (launches[KERNEL] == 0
                or sum(launches.values()) != launches[KERNEL]
                or not losses.size or not np.isfinite(losses).all()
                or not np.isfinite(rmse).all()
                or rmse.shape != (CLI_AR_PREDICT + 1, 2)
                or skipped == bool(figs)):
            raise AssertionError(f"ingest16: launches {launches}, losses "
                                 f"{losses}, RMSE {rmse}, figs {figs}, "
                                 f"skip line {skipped}")
        log("ingest16", f"cli.train_predict.main, flagship config cut "
                        f"(bf16, 1 epoch, AR1, {CLI_PERIODS}, AR"
                        f"{CLI_AR_PREDICT} forecast): {launches[KERNEL]} "
                        f"{KERNEL} launches, nothing else; "
                        f"{len(info['iterations'])} losses finite; RMSE by "
                        f"lead {np.round(rmse, 4).tolist()} finite")
        log("ingest16", (f"figs/: {figs}" if figs else
                         "plots skipped: matplotlib is not installed "
                         "(the driver's line; no figs/ file written)"))
        secs["phase"] = time.perf_counter() - t_phase
        log("ingest16", "seconds: " + ", ".join(
            f"{k} {v:.1f}" for k, v in secs.items()) + f" ({card_line})")
        return {"k1": launches[KERNEL], "seconds": secs}
    finally:
        shutil.rmtree(root, ignore_errors=True)



def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for 3 forwards, "
                         "2 train steps with each level-0 kernel, 2 "
                         "HEALPix-64 train steps, 2 train64f32 steps and 2 "
                         "ens16 member steps beside 2 single steps")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    # what the port's entry points do before their first CUDA allocation
    from deepsphere_weather_torch._device import ask_expandable_segments

    asked = ask_expandable_segments()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card_line = card()
    log("card", card_line)
    log("card", "allocator: " + (
        "expandable segments, asked for by the port "
        "(`_device.ask_expandable_segments`, as its entry points do)"
        if asked else "the environment's setting, which the port keeps: "
        + repr(os.environ.get("PYTORCH_ALLOC_CONF")
               or os.environ.get("PYTORCH_CUDA_ALLOC_CONF"))))
    # every geometry of the run is built here from nothing, into a cache of
    # its own (spawned ranks and subprocesses inherit it), so no reading
    # depends on what an earlier run left in the shared cache
    cache = tempfile.mkdtemp(prefix="dsw_cache_")
    os.environ["DSW_TPU_CACHE"] = cache
    TEMP_ROOTS.append(cache)
    try:
        return _phases(args, device, t_start, card_line)
    finally:
        for root in TEMP_ROOTS:
            shutil.rmtree(root, ignore_errors=True)


def _phases(args, device, t_start, card_line) -> int:
    """Every phase after the card line, in order."""
    import torch

    phase_build()
    ell_parity, block_fp32 = phase_parity(device, (SLICE_SUBDIV, BIG_SUBDIV),
                                          MATVEC_WIDTH)
    gather = phase_gather(device, (SLICE_SUBDIV, BIG_SUBDIV), MATVEC_WIDTH)
    mixed = phase_mixed(device, (SLICE_SUBDIV, BIG_SUBDIV), MATVEC_WIDTH)
    k3_err, k4 = phase_parity_regimes(device, (SLICE_SUBDIV, BIG_SUBDIV),
                                      BATCH)
    phase_parity_backward(device, SLICE_SUBDIV, MATVEC_WIDTH)
    phase_parity_backward(device, BIG_SUBDIV, MATVEC_WIDTH)
    ell_rows = phase_parity_rows(device, (SLICE_SUBDIV, BIG_SUBDIV),
                                 MATVEC_WIDTH)
    fig = phase_slice(device, SLICE_SUBDIV, BATCH, N_STEPS)
    phase_train_check(device, SLICE_SUBDIV, TRAIN_CHECK_BATCH)
    tr = phase_train(device, SLICE_SUBDIV, card_line)
    tr64 = phase_train64(device, BIG_SUBDIV, card_line)
    f32 = phase_train64f32(device, card_line)
    shipped = phase_shipped100km(device, card_line)
    bn16 = phase_bn16(device, card_line)
    ens16 = phase_ens16(device, card_line, tr["ms"]["train16"],
                        args.profile)
    remat16 = phase_remat16(device, card_line)
    # host-only work runs in threads beside the rank phases, whose ranks
    # are processes of their own that the threads do not hold up through
    # the interpreter lock: prep16's experiment, ingest16's GRIB tree and
    # remap, ens64's toy store (their seconds overlap the rank phases')
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        host_jobs = (pool.submit(phase_prep16, card_line),
                     pool.submit(ingest16_host), pool.submit(ens64_store))
        try:
            meshes = phase_meshes(device, card_line, tr["per_iter"],
                                  tr64["per_iter"], ens16["widths"], bn16)
        finally:
            # removed at the end of the run, whatever fails before the
            # phases that remove them
            TEMP_ROOTS.extend(job.result()["root"] for job in host_jobs
                              if job.exception() is None)
    prep, ingest_host, store = (job.result() for job in host_jobs)
    log("times", "prep16, ingest16's host stages and ens64's toy store ran "
                 "in threads beside the rank phases: their seconds and host "
                 "readings, and the ranks' step times, are taken under that "
                 "contention")
    ens64 = phase_ens64(device, card_line,
                        shipped["configs"][SHIPPED_REMAT]["remat"], store)
    node, ensmesh, bnmesh, gridsnode = (meshes[k] for k in (
        "node", "ensmesh16", "bnmesh16", "gridsnode400"))

    from deepsphere_weather_torch.ops import BlockSparseOperator

    t_rows = time.perf_counter()
    op3 = BlockSparseOperator.from_scipy(
        _laplacian(SLICE_SUBDIV), dtype=torch.bfloat16, rows_per_super=0,
        device=device)
    rows = [
        kernel_row(KERNEL, fig["model"].geometry.cheb_ops[0].bcsr, device,
                   SLICE_SUBDIV, BATCH, {
                       "serve": (fig["launches"], 0),
                       "train16": tr["launches"][KERNEL],
                       "train64": tr64["launches"]}),
        kernel_row(PLAIN_KERNEL, op3, device, SLICE_SUBDIV, BATCH,
                   {"train16_plain": tr["launches"][PLAIN_KERNEL]}),
        kernel_row_rows(device, SLICE_SUBDIV, BATCH, node["launches"]),
        kernel_row_ell(ell_parity, ell_rows, f32, shipped),
    ]
    # ens64's member steps (K5 folding the members into each ELL launch)
    # and its run_deep_ensemble
    for path, (fwd, bwd) in ens64["launches"].items():
        rows[3]["launches_by_path"][path] = [fwd, bwd]
        rows[3]["launches_forward"] += fwd
        rows[3]["launches_backward"] += bwd
        rows[3]["launches"] += fwd + bwd
    rows[3]["launches_other_paths"] = {
        "ens64_deep_ensemble": ens64["ensemble_launches"]}
    rows[3]["launches"] += ens64["ensemble_launches"]
    rows[3]["ens64_folded_shape"] = ens64["folded"]
    rows[3]["ens64"] = {k: ens64[k] for k in (
        "single_gib", "member_gib", "m_max", "max_gib", "member_ms",
        "single_ms", "busy_ms", "member_check", "ensemble_seconds")}
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], k3_err)
    # the fp32-x regime (the gather body) and K1's mixed regime (fp32 A,
    # bf16 x) at x[3072, 1024] and x[49152, 1024]: each held to its plain
    # version before it was timed
    for row, kname in ((rows[0], KERNEL), (rows[1], PLAIN_KERNEL)):
        row["fp32_x"] = {"fp32_a": block_fp32[kname],
                         "bf16_a": gather["bf16_a"][kname]}
    rows[1]["fp32_x_rows"] = gather["rows"][PLAIN_ROW_KERNEL]
    rows[2]["fp32_x"] = gather["rows"][ROW_KERNEL]
    rows[2]["mixed"] = mixed[ROW_KERNEL]
    rows[0]["mixed"] = mixed[KERNEL]
    # K4's function: K3's kernel with round_a=False (fp32 A, bf16 x)
    rows[1]["round_a_false"] = k4
    # K3's row range beside K2, on the same shard (parity phase only on
    # the main paths: the geometry builds the super-row layout)
    k3_rows = row_range_times("plain", device, SLICE_SUBDIV, BATCH)
    rows[1]["rows_range"] = {k: k3_rows[k] for k in (
        "ms", "host_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    k1_64, k3_64 = time_step_products(tr64["products"], BIG_SUBDIV, device,
                                      card_line)
    rows[0]["train64_shapes"] = k1_64
    rows[1]["train64_shapes"] = k3_64
    # K2 at the node64 step's shapes beside cuSPARSE's CSR row slice
    rows[2]["node64_shapes"] = k2_node64_shapes(device, node["shapes64"],
                                                card_line)
    PHASE_SECONDS["kernel rows"] = time.perf_counter() - t_rows
    log("times", f"slice: {fig['step_ms']:.2f} ms per forecast step (batch "
                 f"{BATCH}, host clock, {N_STEPS} steps), {fig['submit_ms']:.1f} "
                 f"ms for {N_SUBMIT} concurrent submits, forward "
                 f"{fig['forward_ms']:.3f} ms (CUDA events); {KERNEL} "
                 f"{rows[0]['ms']:.4f} ms, {PLAIN_KERNEL} {rows[1]['ms']:.4f} "
                 f"ms per launch; train step HEALPix-{SLICE_SUBDIV} batch "
                 f"{BATCH}: K1 {tr['ms']['train16']:.2f} ms, K3 "
                 f"{tr['ms']['train16_plain']:.2f} ms; HEALPix-{BIG_SUBDIV} "
                 f"batch {HP64_BATCH}: {tr64['ms']:.2f} ms, "
                 f"{tr64['peak_gib']:.2f} GiB peak; {ROW_KERNEL} "
                 f"{rows[2]['ms']:.4f} ms per launch ({PLAIN_ROW_KERNEL} "
                 f"{k3_rows['ms']:.4f} ms); K4 ({PLAIN_KERNEL}, round_a="
                 f"False) {k4['ms']:.4f} ms; over the HEALPix-{BIG_SUBDIV} "
                 f"step's {len(k1_64)} shapes {KERNEL} "
                 f"{sum(r['ms'] for r in k1_64):.4f} ms, {PLAIN_KERNEL} "
                 f"{sum(r['ms'] for r in k3_64):.4f} ms; on 2 ranks sharing the "
                 f"card (not a scaling number): HEALPix-{SLICE_SUBDIV} "
                 f"{node['ms16']:.2f} ms, HEALPix-{BIG_SUBDIV} "
                 f"{node['ms64']:.2f} ms per step, {node['peak64_gib']:.2f} "
                 f"GiB peak per rank ({card_line})")
    if args.profile:
        phase_profile(tr["model"], device, BATCH, tr["steps"], tr64["step"],
                      f32["step"])
    try:
        cli2 = phase_cli2rank(device, card_line, prep)
        proto = phase_protocol(device, card_line, tr["ms"]["train16"], prep)
        serve16 = phase_serve16(device, card_line, proto)
        swag16 = phase_swag16(device, card_line, proto)
        ens_cli = phase_ensemble16(device, card_line, prep)
        xyear = phase_xyear16(device, card_line, proto)
    finally:
        shutil.rmtree(prep["root"], ignore_errors=True)
    prof16 = phase_profile16(device, card_line)
    rows[0]["launches_protocol16"] = proto["parts"]
    rows[0]["xyear16"] = {k: xyear[k] for k in ("ms_per_step", "writer_share",
                                                "peak_gib")}
    rows[0]["launches_swag16"] = swag16["parts"]
    grids = phase_grids400(device, card_line)
    ingest16 = phase_ingest16(device, card_line, ingest_host)
    rows[0]["launches_grids400_cli"] = grids["cli_parts"]
    # K1 per launch at each of the O24 voronoi level 0's step widths,
    # forward layout and the transposed one its backward runs
    rows[0]["grids400_o24_shapes"] = grids["rows"]
    # the paths of this round's mesh phases: K1 where no node axis is
    # sharded, K2 where one is
    mesh_paths = {
        KERNEL: [("ensmesh16_2x1x2", ensmesh["launches"]["ensmesh16_2x1x2"]),
                 ("ensmesh16_rollout",
                  ensmesh["launches"]["ensmesh16_rollout"])],
        ROW_KERNEL: [("ensmesh16_1x2x2",
                      ensmesh["launches"]["ensmesh16_1x2x2"]),
                     ("remat16_1x2x2", ensmesh["launches"]["remat16_1x2x2"])]
        + list(gridsnode["launches"].items())}
    for path, (kernel, counts) in bnmesh["launches"].items():
        mesh_paths[kernel].append((path, counts))
    for path, (fwd, bwd) in [("protocol16", (proto["forward"],
                                             proto["backward"]))] + list(
            serve16["launches"].items()) + list(
            bn16["launches"].items()) + list(
            ens16["launches"].items()) + list(
            swag16["launches"].items()) + list(
            remat16["launches"].items()) + list(
            grids["launches"].items()) + [
            ("xyear16", xyear["launches"])] + mesh_paths[KERNEL]:
        rows[0]["launches_by_path"][path] = [fwd, bwd]
        rows[0]["launches_forward"] += fwd
        rows[0]["launches_backward"] += bwd
        rows[0]["launches"] += fwd + bwd
    for path, (fwd, bwd) in mesh_paths[ROW_KERNEL]:
        rows[2]["launches_by_path"][path] = [fwd, bwd]
        rows[2]["launches_forward"] += fwd
        rows[2]["launches_backward"] += bwd
        rows[2]["launches"] += fwd + bwd
    # the paths run in other processes or through whole drivers, whose
    # launches are counted as a total: cli2rank's ranks (K2) and rank 0's
    # prediction with the one-process run beside it (K1); ensemble16 (K1)
    rows[0]["launches_other_paths"] = {"cli2rank": cli2["k1"],
                                       "ensemble16": ens_cli["k1"],
                                       "ingest16": ingest16["k1"]}
    rows[2]["launches_other_paths"] = {"cli2rank": cli2["k2"]}
    for row in (rows[0], rows[2]):
        row["launches"] += sum(row["launches_other_paths"].values())
    # profile16's sweep: level 0 of HEALPix-32 in fp32, the ELL kernel
    fwd, bwd = prof16["launches"]
    rows[3]["launches_by_path"]["profile16_sweep"] = [fwd, bwd]
    rows[3]["launches_forward"] += fwd
    rows[3]["launches_backward"] += bwd
    rows[3]["launches"] += fwd + bwd
    # K2 at the shapes of this round's phases: the member-folded level-0
    # widths and the voronoi transposed layout
    rows[2].update(k2_new_shapes(device, gridsnode["voronoi"], BATCH))
    # K5 (`custom_vmap`, pallas_spmm.py:998): the vmap rule of the
    # registered op, which launches K1 once per product for all members
    rows[0]["k5_vmap_rule"] = {
        "replaces": "deepsphere_weather_tpu/ops/pallas_spmm.py:998",
        "source": "deepsphere_weather_torch/ops/bcsr.py", **serve16["k5"],
        "launches_by_path": {
            "serve16_ensemble": serve16["launches"]["serve16_ensemble"],
            "ens16_train": ens16["launches"]["ens16_train"],
            "swag16_export": swag16["launches"]["swag16_export"]},
        # ens64's member steps: the rule over the ELL op (`spmm_ell`)
        "launches_by_path_ell": {
            path: list(n) for path, n in ens64["launches"].items()
            if path != "ens64_single"},
        "widths_ens16": ens16["widths"][:LAUNCHES_PER_FORWARD],
        "widths_ens16_single": ens16["single_widths"][:LAUNCHES_PER_FORWARD],
        # the rule folds the members into K2's row-sharded product too
        # (`spmm_rows`, the JAX rule around the partitioned op)
        "covers": [KERNEL, ROW_KERNEL, ELL_KERNEL],
        "row_rule_source": "deepsphere_weather_torch/ops/bcsr.py (spmm_rows)",
        "launches_by_path_rows": {
            "ensmesh16_1x2x2": ensmesh["launches"]["ensmesh16_1x2x2"]}}
    total = time.perf_counter() - t_start
    log("times", "phases (wall s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; the rest {total - sum(PHASE_SECONDS.values()):.1f}")
    log("times", f"total {total:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
