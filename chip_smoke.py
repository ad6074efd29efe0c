#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (floodseg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # every phase, as below
    python3 chip_smoke.py --k1 [PARENT]  # K1 alone: build, check, time (about 30 s);
                                   # PARENT: a checkout whose K1 is timed in turns with this one
    python3 chip_smoke.py --k2     # K2 alone: build, check, time (about 20 s)
    python3 chip_smoke.py --k3     # K3 alone: build, check, time (about 20 s)
    python3 chip_smoke.py --train  # the training phases alone: 3t, 4t and 14-17
    python3 chip_smoke.py --k1-bwd # phase 3t alone: K1 and K1-bwd at the training shapes
    python3 chip_smoke.py --test   # the evaluation phases alone: 18, 18k, 18c and 5p
    python3 chip_smoke.py --gan    # the s4GAN phases alone: 4g, 19 and 20
    python3 chip_smoke.py --u2pl   # the U2PL phases alone: 4u and 21
    python3 chip_smoke.py --cli    # phase 22 alone: the CLI on the card
    python3 chip_smoke.py --ddp    # phase 23 alone: data parallelism on the card
    python3 chip_smoke.py --ddp-faults  # 23b's contrastive check against planted faults
    python3 chip_smoke.py --int8-enc  # phase 24 alone: the int8 encoder
    python3 chip_smoke.py --remat  # phase 25 alone: rematerialisation
    python3 chip_smoke.py --segm   # phase 26 alone: the standalone Segmenter stack
    python3 chip_smoke.py --converge  # phase 27 alone: the convergence gates, the launchers

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. No CUDA device -> exit 1 before anything else.
2. Build the hand-written kernels from csrc/ with nvcc (sm_90a) and the
   image codec with the host C++ compiler, one compiler for each source,
   all at once: warp.cu (K1, K1-bwd, K2), resize.cu (K3) and jpeg.cpp; ptxas's
   registers and spills for each kernel instantiation; for K1, K2 and K3,
   cuobjdump's count of slow-pipe instructions inside each instantiation's
   loops.
3. Each kernel against its plain PyTorch version, on the card, at the
   shapes the flow-predict paths give it: K1 and K2 on random grids and on
   the main path's own grids, K2 also on a grid that clamps every point to
   one corner and on the identity grid, and in both of its designs
   (ping-pong at 32x32, single-buffer at 67x120); K3 on the interpolated
   stack the int8 main path feeds it in its first window (24x32x32x4096
   -> 65x65), on random data in both align modes, at an odd shape whose C
   is not a 16-channel vector, with values far past the clip range, and
   on every finite bf16 value through an identity resize at four scales;
   K1 also on a grid that clamps every point to one corner. K1 and K2 must
   be bit-equal to their plain versions (by integer view); K3's int8
   outputs must be equal.
   Then each kernel's time on the main path's inputs (CUDA events, median,
   L2 flushed and the host's enqueue hidden behind a sleep kernel before
   each launch; K1 on the chain's head grid and on the identity grid of
   the key-map resample) beside the plain version's, the least time the
   card could take (bound), and a PyTorch library yardstick (F.grid_sample
   for K1 and K2; for K3, F.interpolate then the torch quantize, a
   two-call composition, since no single call computes K3).
3d. K1, K2 and K3 again at the DeepLabV3 path's shapes (C = 2048): K1
   (1, 64, 64, 2048) -> (1, 32, 32, 2048) on random grids, the main path's
   grids, the identity and the corner grid; K2 23 steps on (1, 32, 32, 2048) (a 32-
   channel tile, so 64 blocks); K3 on the stack the DeepLabV3 int8 path
   feeds it (24x32x32x2048 -> 64x64). The same tolerances, and each timed
   beside its bound.
3v. K1 and K2 at the ViT path's shapes (C = 768): K1 up-samples the
   (1, 16, 16, 768) token map to the 32x32 block grid (random grids, the
   main path's grids, the identity and the corner grid); K2 23 steps on (1, 32, 32, 768)
   (a 32-channel tile, so 24 blocks; the count is logged beside the
   card's SMs). The same tolerances, each timed beside its bound and
   F.grid_sample.
3c. K1 and K2 at the crop route's shapes (phase 12): PSPNet-50 encodes a
   433 px crop to (1, 55, 55, 4096) (read from the model); K1 warps it onto
   the first window's first crop grid (27x27) and, align_corners=True,
   onto the 67x120 full-frame identity grid (the key-map resample, an
   up-sample) and a 67x120 grid clamped to one corner; K2 23 steps on (1,
   27, 27, 4096) (its geometry logged). The same tolerances, each timed
   beside its bound and F.grid_sample.
4. The flow-predict slice in float32 (TF32 off) on the card against the
   same slice on the CPU: PSPNet-50 at 129 px key frames from a clip of
   128 px frames (SLICE_FRAME_HW, every slice check), n = 5, with each
   decoder; with an int8 decoder, the share of int8 lanes one step apart.
4b. The int8 decoder on the card against the CPU: the same int8 input and
   int8 weights give equal int32 accumulators; the bf16 logits of
   int8_seghead_decode agree within 2 bf16 ulps of their largest magnitude.
4d. The same for the DeepLabV3 slice, with each decoder.
4e. The DeepLabV3 int8 decode on the card against the CPU: every int8 conv
   of int8_deeplab_decode (the four ASPP branches, the projection, the
   trailing 3x3) replayed on the card from the CPU's int8 input and
   weights gives the CPU's int32 accumulator; the bf16 logits agree within
   the stated share of their largest magnitude.
4v. The Segmenter ViT-B/32 slice on the card against the CPU, 128 px key
   frames (4x4 tokens, 8x8 grids), n = 5, the MaskTransformer decoding a
   window as one call: in float32, then in bf16 (bf16 products reduced in
   float32 on the card, as the builders run them), logits and encodings
   within SLICE_TOL and ENC_TOL; the bf16 logits are read once more with
   PyTorch's default reduced-precision reduction, for the record.
5. The main path: PSPNet-50 in bf16 at full width, 513 px key frames,
   n = 25, 32x32 block grids, through make_cached_flow_predict_fn, with
   bench.py's protocol (8 timed windows, median of 5 passes). The launch
   counters are set to 0 before and read after: K1 must have launched 3
   times and K2 twice per window, K3 never.
   Then torch.profiler over two more cached windows: the device's busy
   time and idle share per window, the kernels a window, kernel time by
   name and by family (KERNEL_FAMILIES; the table and the trace go to
   build/profile/).
6. The int8 main path: the same model, windows and protocol with
   int8_decode=True. K1 3, K2 2 and K3 1 launches per window; frames/s and
   peak memory; the profiler over two cached windows; the device-time
   split of the int8 decode's pieces (im2col copy and torch._int_mm, timed
   with CUDA events at the path's shapes).
7. The DeepLabV3 main path (bench.py --arch deeplabv3 --no-int8):
   DeepLabV3-50 in bf16 at full width, 512 px key frames, n = 25, the bf16
   DeepLabHead decoding each window as one call; the same protocol and
   launch checks (K1 3, K2 2, K3 0 per window), profiler, peak memory.
8. The same with the int8 DeepLabHead (K3 1 per window), then the device-
   time split of its int8 decode at 25x64x64x2048 (each int8 conv's im2col
   copy and torch._int_mm, CUDA events).
9. The ViT main path (bench.py --arch vit): ViT-B/32 in bf16 at full
   width, 512 px key frames (16x16x768 token maps), n = 25, the bf16
   MaskTransformer decoding each window as one call (the ViT has no int8
   decoder); the same protocol and launch checks (K1 3, K2 2, K3 0 per
   window), profiler, peak memory.
   Each main path runs with only its own model on the card, so its peak
   memory is its own.
10. The image codec on this machine: a 1072x1920 synthetic frame through
   the port's JPEG encoder and decoder at q92 (PSNR above 35 dB), ms a
   frame on one thread and on 8 threads.
11. The cached route from files, bench.py's protocol: a 512 px tree from
   the port's writer, read by FlowDataset and the DataLoader (JPEG decode,
   resize to 513, device_put), PSPNet-50 bf16, n = 25; frames/s with the
   batches loaded before the timed loop and with the loader in the loop,
   the per-stage host breakdown, K1 3 and K2 2 launches a window, and the
   streamed windows' maps equal to the preloaded ones.
12. The CLI's default crop route at full width through run_flow_predict:
   a 1072x1920 tree of 51 frames (2 windows), 28 crops of 433 px a window,
   n = 25, PSPNet-50 bf16, metrics, palette PNGs and the MJPG AVI. K1 84
   and K2 56 launches a window; 50 PNGs; an AVI the port's reader reads as
   50 frames; seconds a window split into the crops on the device, the
   probabilities' copy to the host and the float64 canvas; device busy and
   the copies from torch.profiler; peak memory.
12b. The crop route in float32 on the card against the CPU at 128x192,
   64 px crops, n = 5: probabilities within 1e-4, maps equal away from
   near-ties.
Then the training phases, last, each model alone on the card:
3t. K1 and K1-bwd (K1's backward, csrc/warp.cu) at each architecture's
   training shapes (batch 2), in float32 and bf16: PSPNet-50's (2, 55, 55,
   4096) -> 27x27 (a chain's head, from a 433 px crop) and (2, 27, 27,
   4096) -> 27x27 (its steps); DeepLabV3's (2, 55, 55, 2048) and (2, 27,
   27, 2048) -> 27x27 and the ViT's (2, 13, 13, 768) -> 26x26 (an
   up-sample of the token map of a 416 px crop: about 16 output points
   scatter onto each source pixel) and (2, 26, 26, 768) -> 26x26. Each on
   random grids, the training batch's own crop grids (a synthetic
   1072x1920 clip's chains through the flow train transform at the
   architecture's crop), the identity grid and a grid that clamps
   every point to one corner (every tap on one pixel). K1 must be
   bit-equal to its plain version (by integer view); K1-bwd bit-equal (by integer
   view) to its plain version computed on the CPU, whose index_add_ sums
   in the order the kernel keeps (on the card index_add_ is atomic), in
   float32 and bf16, and two launches on one input bit-equal. K1-bwd also
   where its index build's working arrays take a device workspace, a (1,
   67, 120) grid onto (1, 134, 240, 256), random, identity and corner
   grids, and with C = 5 on grad_out at an odd element offset, both
   dtypes. Both timed in
   float32 beside the bytes bound, the plain version and the library
   (F.grid_sample, and aten.grid_sampler_2d_backward on NCHW for K1-bwd);
   K1-bwd at each head shape in bf16 too, and the workspace route in
   float32.
4t. Train steps on the card against the CPU, float32 with TF32 off and
   the flow config's SGD (lr 1e-4, heads 10x), each from the same initial
   state, every dropout with the same keep masks (one per module, drawn on
   the CPU): one interpolated, one plain and one eval step of PSPNet-50
   and DeepLabV3-50 with their aux heads at 65 px and of ViT-B/32 at
   128 px (4x4 tokens on 8x8 grids), and one supervised step of PSPNet-50
   with the aux loss at 0.4; batch 2, frame_delta 5. Losses within rtol
   1e-4, every parameter and BN statistic within 1e-4 of its tensor's
   largest magnitude, eval counts within 1% of the pixels (OHEM's
   min_kept of 100000 exceeds the pixels: no mining). What each step
   changed (p1 - p0: the gradient through K1-bwd, momentum and decay, the
   BN statistics' update) is held tensor by tensor: the same tensors move,
   and the card's change is within STEP_FLOOR_FACTOR times the CPU float32
   change's distance to the float64 change (the same steps in float64 on
   the CPU), and never tighter than STEP_ABS, of the tensor's largest
   change.
14-17. Training at full width on a 1072x1920 tree of 100 frames from the
   port's writer, the repository's configurations (float32 with TF32 off,
   batch 2, SGD 1e-4 with the heads at 10x, OHEM 0.7 / 100000, random
   weights): 14 flow-supervised PSPNet-50 with its aux head, 433 px crops,
   n = 25, through run_flow_fit (14 steps: 2 warm-up, 10 timed with a
   synchronise after each, the last 2 under torch.profiler; 3 validation
   frames); 15 flow-supervised DeepLabV3-101 with its aux head (433 px),
   16 flow-supervised ViT-B/32 (416 px crops, round_train of 433; 13x13
   tokens), each 8 steps (2 warm-up, 4 timed, 2 profiled) and 2
   validation frames; 17 the single-frame supervised method through
   run_fit and SemDataset: PSPNet-50 with the aux loss at 0.4, 873 px
   crops, the rotating train transform padded with MEAN, 8 steps, 2
   validation crops. Each: the loader alone first (ms a batch on 8
   threads); ms a step and samples/s, the step's wait for its batch,
   device busy, the idle share and ms a step by kernel family, peak
   memory. Checks: K1 48 and K1-bwd 48 launches every flow step (and K1 48
   a validation frame), K2 and K3 none, and no launch at all in phase 17;
   a finite loss; every BN's running mean moved but the aux head's in flow
   training (which never runs it); after the first flow step each aux
   parameter equals p0 - 10 lr wd p0 (a zero gradient, decayed and moved).
Then s4GAN training:
4g. One flow_gan and one gan step on the card against the CPU, each from
   one state at step 1 (so the self-training gate can open): PSPNet-50 with
   its aux head at 65 px and a random discriminator (ndf 64), float32 with
   TF32 off, batch 2, frame_delta 5, the configs' generator SGD without the
   aux head (flow_gan lr 1e-4, wd 1e-4; gan lr 2.5e-4, wd 5e-4) and the
   discriminator's Adam (lr_D 1e-4, betas (0.9, 0.99)), every dropout of
   both with one keep mask drawn on the CPU, and a threshold_st halfway
   between the two unlabeled samples' confidences (read on the CPU), so
   st_count is 1 of 2. Losses within rtol 1e-4; st_count 1 on both; every
   generator parameter and BN statistic within 1e-4 of its tensor's
   largest magnitude or 32 times the CPU float32 step's distance to
   float64, whichever is larger; of each discriminator tensor at most
   1e-3 of the elements farther than 1e-4 (Adam turns a near-zero
   gradient's rounding into a full step); what the step changed within
   4t's floor rule; every aux parameter equal to its start to the bit on
   both.
19. flow_gan at full width through run_gan_fit on phase 14's tree:
   PSPNet-50 with its aux head, 433 px crops, n = 25, batch 2, the flow_gan
   config, random weights, 10 steps (2 warm-up, 6 timed with a synchronise
   after each, 2 under torch.profiler), 2 validation frames. The same
   report as 14, the wait covering the three role batches, and the
   discriminator's 4x4 convolutions (told from the generator's by their
   operands' shapes in the trace) as a family of their own. Checks: K1 96
   and K1-bwd 96 launches every step (two generator forwards), K1 48 a
   validation frame, K2 and K3 none; every step's loss_s, loss_d and
   loss_fm finite; every discriminator parameter moved; every aux
   parameter equal to its start to the bit after every step.
20. gan at full width: PSPNet-50, 873 px crops through SemDataset, the gan
   config, 6 steps (2 warm-up, 2 timed, 2 profiled), 2 validation crops; no
   launch at all; the same report and checks.
Then evaluation:
18. The test at full width through run_test on phase 14's tree (test.txt
   and test2.txt, limit_test_batches = 2, so 3 samples), PSPNet-50 float32
   with TF32 off, random weights: (a) flow_supervised, the crop route: 28
   crops of 433 px a sample in one device call, K1 48 launches a sample
   ((28, 55, 55, 4096) -> 27x27 at the chains' heads, (28, 27, 27, 4096)
   -> 27x27 at their steps), K2 none; (b) the same under no_cropping, whole
   frames at (433, 650): K1 48 a batch; (c) supervised, the multi-scale
   flip test: 873 px crops over the 1143x2048 rescale (8 crops and their
   flips, one call), no launch at all. Each: seconds a sample split into
   the device call, the copy to the host and the canvas; device busy and
   idle share (torch.profiler); peak memory; the metrics finite, the keys
   Runner.test's.
18k. K1 at the test's shapes in float32: (a)'s crop route, (28, 55, 55,
   4096) and (28, 27, 27, 4096) -> 27x27, and (b)'s whole frames, (1, 55,
   82, 4096) and (1, 67, 120, 4096) -> 67x120, each on its route's own
   first grids (the chains' head and first step), random grids, the
   identity grid and a corner-clamped grid: bit-equal to its plain version
   by integer view; each timed beside its bytes bound, the plain version
   and F.grid_sample (NCHW).
18c. run_test card against CPU in float32 at 128x192 frames, n = 5
   (flow_supervised): the crop route (65 px crops), each sample's crop
   probabilities within 1e-4 and its map equal away from near-ties (twice
   that); no_cropping, each whole-frame batch's probabilities within 1e-4,
   its map equal away from near-ties and its counts equal where the map
   is; the metrics equal where every map is.
5p. profile_predict_phases at the main path's shapes (PSPNet-50 bf16,
   513 px, n = 25): ms per region (predict_encoder, predict_warp,
   predict_fusion, predict_decoder); one composed clip launches K1 3 and
   K2 2 times and its maps equal make_flow_predict_fn's away from
   near-ties (a top-2 logit gap above 2**-5 of the window's largest
   |logit|), with at least 0.5 of the pixels clear and 0.98 equal;
   make_cached_flow_predict_fn(fused_argmax=False) over phase 5's windows
   gives the fused maps at every pixel but two-ulp ties of its own bf16
   logits, and its maps are their argmax.
Then U2PL (the contrastive method), after evaluation:
4u. One sup_step, the sync, one semi_step and a true_ema semi_step on the
   card against the CPU (float32, and float64 for the floor): PSPNet-50
   with its aux and rep heads and a teacher of its own init, 65 px, batch
   2 + 2, TF32 off, the contrastive config's settings with max_enqueue 48
   and the bank's caps cut to 64 (class 0: 96) so that a ring wraps, the
   cutmix coin taken, every dropout with one keep mask a module and shape
   and every draw from CPU generators (HostDraws), shared by the runs;
   each step runs on the card and in float64 from a copy of the CPU
   float32 trajectory's state, with the CPU's teacher outputs, from which
   every mask is computed (the card's own within 1e-4 of their scale or
   4t's floor rule; the pixels where they would move a pseudo-label or an
   entropy mask are named: near-ties, at most 1e-3 of them). Losses within
   rtol 1e-4; student and teacher parameters and BN statistics within
   4t's rules, what the step changed held per tensor in L2 (a BN over 36
   values, the PPM's 3x3 bin, makes single channels too noisy for 4t's
   largest-element form); the bank's counts and pointers equal, its keys
   within 1e-4 of their scale; the teacher's parameters the student's
   tensors after the aliased semi step, its own after the true_ema one.
21. contrastive at full width through run_contrastive_fit on phase 14's
   tree: PSPNet-101 (the configuration's depth) with aux and rep heads,
   873 px crops, batch 2 + 2, the configuration's settings (the (5, 50000, 256) bank),
   random weights; 4 epochs of 2 steps with sup_only_epoch 1: 2 sup steps,
   the sync, 6 semi steps (2 warm-up, 2 timed, 2 under torch.profiler),
   validation every second epoch over one crop. The report of 14 (ms a sup
   and a semi step, the wait for batches, device busy and idle share, ms
   by kernel family, peak memory). Checks: no launch of K1, K2, K3 or
   K1-bwd; every loss finite; contra_loss non-zero on a semi step; no class
   count above its cap, none growing by more than max_enqueue a step; the
   teacher's parameters the student's tensors after every semi step, its
   BN statistics its own; validation served the teacher; no step copies
   to the host (the profiled window, the last epoch's steps without any
   epoch's read-back, traces kernels and no copy).
22. The CLI in process on the card (floodseg_tpu_torch.cli.main; ``run``
   is ``main`` returning its Runner): PSPNet-50 flow_supervised from
   configs/{train_base,train_flow_supervised,dataset_flow,pspnet}.yaml on
   phase 14's tree (433 px crops, n = 25, as the configs give them), 2
   epochs of 2 steps, one val and one test batch: ``fit`` (checkpoints,
   then the test and the crop-route predict on the best one, its frames
   cut to 536x960, ``--data.resize_factor_predict 0.5``: 6 crops a window
   where 1072x1920 takes 28; phase 12 runs the route at full size),
   ``test --ckpt_path <run>/checkpoints/last``, ``predict`` on
   that checkpoint with no_cropping and the int8 decoder. Each
   subcommand's wall time and launches on a line. Checks: K1, K1-bwd, K2
   and K3 each launched; the state restore_best gives and the one the test
   restores equal, bit for bit, the states the fit saved at those epochs;
   the predict maps equal run_flow_predict's on the same weights, pixel
   for pixel; metrics.json has the keys the JAX Runner writes. Peak memory
   beside the card's name and power limit. Then ``fit
   --data.normalize_on_device true`` and the same fit normalised on the
   host (one epoch of 2 steps under no_cropping, the test skipped): each
   train step's frames reach the card as float16, and the weights and BN
   statistics after it are within 4t's rule (STEP_ABS) of the host fit's.
Then data parallelism (parallel/, the global-batch steps), with rank
processes of this script (``--ddp-rank PART BACKEND PREFIX``, the
rendezvous on a free localhost port, every rank on cuda:0: under NCCL the
port's own (parallel/dist.py), under gloo a group the rank makes first;
their output under build/ddp/):
23. (a) One rank over NCCL: run_flow_fit of phase 14's PSPNet-50 (float32,
   aux head, seed 7) on phase 14's tree, 433 px crops, global batch 2, 2
   steps and 2 validation frames; K1 and K1-bwd launch as in phase 14
   (48 each a step, K1 48 a validation frame); held against phase 14's
   step (the same run in this process, no process group) by 4t's rule:
   what the steps changed, tensor by tensor, within STEP_FLOOR_FACTOR
   times its float32 floor, never tighter than STEP_ABS, of the tensor's
   largest change. The floor is measured as 4t's is, the distance of one
   float32 run to another that computes the same thing: here the same
   steps with each batch's samples reversed (and every dropout mask with
   them), which reorders the sums over the batch as the ranks do (a
   float64 run of PSPNet-50 at this size is out of reach on the CPU, and
   K1 takes float32 and bf16 only). (b) Two ranks on the one card: NCCL with two ranks on cuda:0 is
   tried with one all-reduce (beside (a)'s launch) and refuses ("Duplicate GPU detected"; each
   rank's error logged), so the ranks run on gloo with CUDA tensors. The
   same fit over 2 ranks, 1 + 1 samples: the ranks' states bit-equal, each
   rank's K1 48 and K1-bwd 48 a step and K1 48 for its validation frame,
   the train loss within rtol 1e-4 of (a)'s and what the steps changed
   within 4t's rule (STEP_FLOOR_FACTOR times the floor, never tighter than
   STEP_ABS) of the one-rank run. Then one contrastive sup step, the sync
   and one semi step of PSPNet-50 with its aux and rep heads at 321 px,
   batch 2 + 2, the contrastive loss divided by num_devices = 2, over 2
   ranks against one rank with num_devices 2: the sup and unsup losses
   within DDP_LOSS_REL, the contrastive and total loss within
   DDP_CONTRA_REL, the bank's count of each class within DDP_BANK_REL,
   the ranks' states and banks' counts equal, what the steps changed per
   tensor in L2 (4u's form) within DDP_U2PL_L2 of the change in the
   median tensor and DDP_U2PL_L2_MAX in the largest (no floor: the
   sampling of anchors and negatives does not survive a reordering; the
   limits lie between sound runs and the planted faults of
   ``--ddp-faults``). (c) DP predict through run_flow_predict(no_cropping,
   world) on a predict tree of 3 windows of 512 px frames: phase 5's
   PSPNet-50 bf16 at 513 px, n = 25, a batch of two windows (one a rank)
   and a ragged batch of one (every rank), with the bf16 and the int8
   decoder: every rank's maps (as make_dp_predict_fn returned them) and
   summary equal one device's through run_predict on the non-cached
   route the ranks run, pixel for pixel; rank 0's PNGs and AVI equal
   that run's byte for byte, and no other rank wrote a file; one
   device's run_flow_predict (the cached route) equal in its first
   window and on at least COMPOSED_MIN_EQUAL of all pixels (5p's rule
   for a bf16 rounding elsewhere: it reuses an encoding made alone);
   each rank launches K1 6 and K2 4 (and K3 2 with
   int8). The 2-rank fit of (b), its contrastive steps and (c) run in one
   launch of two rank processes, one part after another (a rank process
   takes 15-20 s to start on the card). Each launch's wall time, and each
   rank's seconds, peak memory and launches by part, beside the card's
   name and power limit.
23f. (``--ddp-faults`` alone) 23b's contrastive check read on a second
   one-rank run and a sound 2-rank run, which must pass every limit, and
   on 2 ranks under each planted fault of DDP_FAULTS (``planted_fault``:
   BatchNorm statistics over a rank's own samples, each rank's dropout
   masks drawn at its own shape, the entropy percentiles over a rank's
   own pixels), which must fail one.
Then the main stack's opt-ins:
24. The int8 encoder (``model.int8_encode``, bench.py --int8-enc). (a) The
   slice card against CPU, float32 with TF32 off, 129 px key frames, n = 5:
   PSPNet-50 with the float32 and with the int8 decoder, DeepLabV3-50 with
   the float32 one; every int8 conv the CPU run makes (the trunk's 52 an
   encode, the decoder's) replayed on the card from the CPU's int8 input
   and weights gives the CPU's int32 accumulator; the int8 maps' lanes off
   logged; the logits' and encodings' mean and largest gaps within
   INT8_ENC_GAP of their scale and the maps equal on INT8_ENC_MAPS of the
   pixels (a rsqrt or rounding difference re-rounds a map at a moved
   scale, and the blocks compound it). (b) bench.py --int8-enc's protocol:
   PSPNet-50 at 513 px and DeepLabV3-50 at 512 px, bf16, n = 25, each with
   the bf16 and the int8 decoder: frames/s, K1 3, K2 2 and K3 0 or 1
   launches a window, the profiler's busy time, idle share and kernels a
   window, peak memory; and one encoder call split by torch.profiler into
   its im2col, torch._int_mm and quantization ranges and the rest. (c) For
   the record: the share of one window's pixels whose class equals the
   bf16 encoder's.
25. Rematerialisation (``model.remat``). (a) Phase 14's flow fit
   (PSPNet-50 float32 with its aux head, 433 px crops, batch 2, 2 steps)
   built with remat and without: the same launches, and what the steps
   changed (every tensor, then the BN running statistics alone) within
   4t's rule (STEP_ABS) of the plain fit. (b) Phase 21's contrastive run
   with the student rematerialised: its checks, ms a semi step and peak
   memory beside phase 21's.
Then the standalone Segmenter stack (floodseg_tpu_torch/segm/, its
launchers and the Lightning export), which launches none of K1-K3:
26. (a) ``python -m floodseg_tpu_torch.segm.train --dataset ade20k`` in
   process at full width: ViT-B/32 (d 768, 12 + 2 layers, patch 32),
   512 px crops, batch 8, the preset's 150 classes, window 512, stride
   480, on a synthetic ADE20K-layout tree from the port's codec (24
   training JPEGs of 683x512 with L-PNG labels 0..150, 4 validation images
   of 640x448): 2 epochs of 3 steps, each followed by the evaluation, then
   a resume to a third epoch, float32 with TF32 off; then 3 steps with
   ``--amp``. Checks: finite losses, log.txt's epochs and keys, the top-3
   index by val_miou and its files, the resumed run ending at step 9, no
   launch of K1, K1-bwd, K2 or K3. Logs ms a step (median after the
   first), seconds an evaluation image, peak memory. (b) A narrow
   Segmenter (d 128, 2 + 1 layers, 64 px) through the same runs on the
   card and on the CPU: one segm.train step (the loss within
   SEGM_LOSS_RTOL, what it changed by 4t's rule), sliding_inference on a
   96x160 image with flip (SEGM_PROB_ATOL, argmax on SEGM_ARGMAX_SHARE),
   attention_maps (SEGM_ATTN_ATOL a layer) and a ViTClassifier's logits
   (SEGM_LOGIT_SHARE). (c) cli/segm_accuracy.py: ViTClassifier ViT-B/16 at
   224 px, 1000 classes, over a synthetic ImageFolder tree of 128 JPEGs,
   images/s of the second pass. (d) cli/segm_inference.py over the 4
   validation images with their masks, cli/show_attn_map.py (layer 11,
   patch and class queries) on (a)'s checkpoint, and cli/export_ckpt.py on
   phase 22's last checkpoint, read back equal by the port's importer.
27. The convergence gates of tests/test_convergence.py on the card, on its
   synthetic tree (30 frames at 96x128, 20 labeled) and config: PSPNet-50,
   5 classes, 30 epochs, batch 4, 65 px crops, seed 1, lr 0.01, float32
   with TF32 off, each through Runner.fit, restore_best and test. (a) The
   supervised gate: best val mIoU >= 0.40, test-on-best test_miou1_epoch
   >= 0.30; (b) the flow_supervised gate: best val mIoU >= 0.12, with K1
   and K1-bwd launched in the fit. Each logs the val mIoU of every epoch,
   the fit's seconds and peak memory. (c) The launchers on (b)'s tree,
   each fit cut to one epoch of 2 steps: cli/launch.py train
   flow_supervised (K1, K1-bwd and K2 launched), test and predict on its
   run; cli/sweep.py experiments/lr_example.yaml --count 2 as two runs in
   their own processes, each with metrics.json and its point's lr and
   batch in config.json; scripts/clean.py over that log dir naming only
   a planted crashed run; cli/export_ckpt.py of (b)'s best state, then
   cli/import_ckpt.py of it, equal bit for bit to Runner.load_torch_ckpt's
   state and, but for the aux head the reference's flow layout lacks, to
   the best checkpoint; ``test --ckpt_path`` of the import through K1;
   ``launch ingress`` stopping on its missing tool.
13. Last (after phase 27): a JSON line {"kernels": [...]} (each kernel's
   max_abs_err is its largest over every check; max_abs_err_by_dtype gives
   the largest in float32 and in bf16 apart), then the nvidia-smi line, then the last line {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from floodseg_tpu_torch.core import full_precision_f32
from floodseg_tpu_torch.core.profiler import PhaseProfiler, cuda_sync
from floodseg_tpu_torch.data import (
    MEAN,
    STD,
    DataLoader,
    FlowDataset,
    SemDataset,
    build_test_transform,
    build_train_transform,
    collate,
    device_put,
    generate_synthetic_dataset,
    predict_windows,
    read_mjpg_avi,
    resize_frames,
    synthetic_clip,
)
from floodseg_tpu_torch.data.image import decode_jpeg, encode_jpeg, imread, write_jpeg, write_png
from floodseg_tpu_torch.models import S4GANDiscriminator, build_model, init_from_generator_
from floodseg_tpu_torch.models.layers import Dropout
from floodseg_tpu_torch.ops import build, launch_counts, quant, reset_launch_counts
from floodseg_tpu_torch.ops.grid_sample import (
    grid_sample,
    grid_sample_backward,
    tap_indices_weights,
)
from floodseg_tpu_torch.ops.u2pl import U2PLDraws, masked_percentile, softmax_entropy
from floodseg_tpu_torch.ops.resize_kernels import (
    resize_quantize_int8_cuda,
    resize_quantize_int8_plain,
)
from floodseg_tpu_torch.ops.warp_kernels import (
    SampleGeometry,
    _chain_geometry,
    _library as warp_library,
    _sample_launch,
    _sample_plan,
    grid_sample_backward_cuda,
    grid_sample_cuda,
    warp_chain_cuda,
    warp_chain_plain,
)
from floodseg_tpu_torch.train import (
    AUX_KEYS,
    ContrastiveConfig,
    FitConfig,
    FitHooks,
    default_fit_config,
    TrainState,
    create_u2pl_state,
    crop_offsets,
    fit,
    flow_g_forward,
    flow_sliding_window_predict,
    flow_transforms,
    make_cached_flow_predict_fn,
    make_flow_eval_step,
    make_flow_phase_fns,
    make_flow_predict_crop_fn,
    make_flow_predict_fn,
    make_flow_train_step,
    make_gan_train_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    make_u2pl_steps,
    profile_predict_phases,
    round_train,
    run_contrastive_fit,
    run_fit,
    run_flow_fit,
    run_flow_predict,
    run_gan_fit,
    run_predict,
    run_test,
    sem_transforms,
    single_frame_g_forward,
    sync_teacher,
)
from floodseg_tpu_torch.train.evaluate import _crop_stack
from floodseg_tpu_torch.train.flow import (
    _predict_decode,
    _predict_encode,
    decode_split_ok,
    flow_train_forward,
)
from floodseg_tpu_torch.video import FlowInterpolator, default_grid, flow_model
from floodseg_tpu_torch.video.grid import crop_motion_vectors_stack_np

# the flow-predict workload of bench.py (SIZE: PSPNet; DL_SIZE: --arch
# deeplabv3 and --arch vit)
FRAME_DELTA = 25
SIZE = 513
DL_SIZE = 512
DL_FEAT_HW = (64, 64)
VIT_TOKENS_HW = (16, 16)  # ViT-B/32 at 512 px
VIT_D = 768
CLIPS_TIMED = 8
PASSES = 5
CLASSES = 5

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor) and
# dense int8 tensor-core rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- checks

def bits_differ(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Elements whose bits differ (float32 or bf16, by integer view)."""
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    return int((got.contiguous().view(bits) != ref.contiguous().view(bits)).sum())


def check_bits(name, got, ref) -> float:
    """A kernel's output bit-equal, by integer view, to its plain version's
    on the same inputs on the card. Returns the max abs error, 0."""
    differ = bits_differ(got, ref)
    err = float((got.float() - ref.float()).abs().max())
    log(f"  {name}: {differ} elements differ from the plain version, max_abs_err "
        f"{err:.3e} -> {'ok' if differ == 0 else 'FAIL'}")
    if differ:
        raise AssertionError(f"{name} is not bit-equal to its plain version ({differ} elements)")
    return err


def check_k1(name, x, grid, align) -> float:
    """K1 bit-equal to its plain version (``check_bits``)."""
    return check_bits(name, grid_sample_cuda(x, grid, align), grid_sample(x, grid, align))


def note_err(errs: dict, kname: str, dtype: torch.dtype, err: float) -> None:
    """Keep the largest error of ``kname`` in ``dtype``: errs[kname][dtype
    name] (the kernels line reports each dtype's and the largest)."""
    by_dtype = errs.setdefault(kname, {})
    tag = str(dtype).replace("torch.", "")
    by_dtype[tag] = max(by_dtype.get(tag, 0.0), err)


def kernel_cases(device, dtype, k1_shape=(1, 65, 65, 4096), grid_hw=(32, 32),
                 chain_steps=FRAME_DELTA - 2, wide_grid=(67, 120), wide_c=256,
                 seed=0):
    """Inputs at the flow-predict path's shapes: K1 warps the 65x65x4096
    encoding onto the 32x32 block grid (both align modes); K2 chains 23
    warps on 32x32x4096, and again on the reference's 67x120 grid."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(k1_shape, generator=g).to(device, dtype)
    grid = (torch.rand((1,) + grid_hw + (2,), generator=g) * 2.2 - 1.1).to(device)
    y0 = torch.randn((1,) + grid_hw + (k1_shape[-1],), generator=g).to(device, dtype)
    grids = (torch.rand((chain_steps, 1) + grid_hw + (2,), generator=g) * 2.2 - 1.1).to(device)
    y0w = torch.randn((1,) + wide_grid + (wide_c,), generator=g).to(device, dtype)
    gridsw = (torch.rand((chain_steps, 1) + wide_grid + (2,), generator=g) * 2.2 - 1.1).to(device)
    return x, grid, y0, grids, y0w, gridsw


def main_path_grids(device, n=FRAME_DELTA, frame_hw=(512, 512), seed=0):
    """The grids phase 5 gives the kernels in its first window: mvs_left
    (n-1, 1, 32, 32, 2) of the synthetic clip of 512 px frames, and the
    identity grid (1, 32, 32, 2) of the key-map resample."""
    clip = synthetic_clip(n + 1, size=frame_hw, frame_ids=(0, n), seed=seed)
    mvs = predict_windows(clip, n)[0]["mvs_left"]
    return (torch.as_tensor(mvs, device=device),
            torch.as_tensor(default_grid(*frame_hw), device=device)[None].contiguous())


def check_kernels(device, **shapes) -> dict:
    """Phase 3a: both kernels against their plain versions, f32 and bf16, on
    random grids (every border case), on the main path's own grids and, for
    K1, on a grid that clamps every point to one corner (a point's four taps
    on one pixel)."""
    errs = {}
    mvs, dg = main_path_grids(device)
    for dtype in (torch.float32, torch.bfloat16):
        x, grid, y0, grids, y0w, gridsw = kernel_cases(device, dtype, **shapes)
        tag = str(dtype).replace("torch.", "")
        for g, align, what in ((grid, False, "random"), (grid, True, "random"),
                               (mvs[0], False, "main-path"), (dg, True, "identity"),
                               (torch.full_like(grid, -1.5), False, "corner")):
            note_err(errs, "grid_sample_cuda", dtype, check_k1(
                f"K1 {tag} x{tuple(x.shape)} {what} grid{tuple(g.shape)} align={align}",
                x, g, align))
        note_err(errs, "warp_chain_cuda", dtype,
                 check_k2(x, y0, grids, y0w, gridsw, mvs, dg))
    return errs


def k2_design(y0) -> str:
    """Which of K2's designs the wrapper takes for y0 (1, gh, gw, C)."""
    _, gh, gw, c = y0.shape
    isz = y0.element_size()
    vec = 16 // isz if (c * isz) % 16 == 0 else 1
    return "ping-pong" if _chain_geometry(gh * gw, c, isz, vec).table_points else "single-buffer"


def check_k2(x, y0, grids, y0w, gridsw, mvs, dg) -> float:
    """K2 bit-equal to its plain version (``check_bits``; its design does the
    plain version's arithmetic in its order) in x's dtype: random grids at 32x32 and
    at the reference's 67x120 (the single-buffer design), the main path's
    own grids from K1's plain output, and two degenerate grids on the same
    input: every point clamped to the top-left corner (the four taps of a
    point coincide and merge) and the identity grid (the 32x32 block
    centres, align_corners=False)."""
    dtype = x.dtype
    tag = str(dtype).replace("torch.", "")
    y0m = grid_sample(x, mvs[0], False)
    ident = dg.expand((mvs.shape[0] - 1,) + tuple(dg.shape)).contiguous()
    corner = torch.full_like(ident, -1.1)
    err = 0.0
    for y, gs, what in ((y0, grids, "random"), (y0w, gridsw, "random"),
                        (y0m, mvs[1:], "main-path"), (y0m, corner, "corner"),
                        (y0m, ident, "identity")):
        err = max(err, check_bits(
            f"K2 {tag} y0{tuple(y.shape)} {what} T={gs.shape[0]} ({k2_design(y)}, every step)",
            warp_chain_cuda(y, gs), warp_chain_plain(y, gs)))
    return err


# ---------------------------------------------------------------- timing

class L2Flush:
    """Writes a buffer larger than the 50 MB L2 before each timed launch."""

    def __init__(self, device):
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.zero_()


def sleep_cycles_per_ms() -> float:
    """Calibrate torch.cuda._sleep: the card's clock cycles per millisecond."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, flush, cycles_per_ms, reps=20, warmup=3) -> float:
    """Median device time of fn() in ms. The L2 is flushed before each
    launch, and a sleep kernel holds the stream while the host enqueues
    fn, so the host's launch overhead is not counted as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # returns once enqueued
    hold = int((2e3 * (time.perf_counter() - t0) + 0.05) * cycles_per_ms)
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(hold)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: int, flops: int):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory rate
    and operations over the float32 rate (the warps use no tensor cores)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k1_bytes(x, grid, out, align_corners) -> int:
    """Bytes K1 must move on this grid: each pixel of x that a tap touches,
    read once; the grid read; the output written."""
    b, h, w, c = x.shape
    idx, _ = tap_indices_weights(h, w, grid.reshape(b, -1, 2), align_corners)
    touched = sum(int(idx[i].unique().numel()) for i in range(b))
    return touched * c * x.element_size() + nbytes(grid, out)


def time_kernels(device, k1_shape=(1, 65, 65, 4096)) -> dict:
    """Phase 3b: bf16 on the main path's own inputs: a key encoding
    (65x65x4096 for PSPNet, 64x64x2048 for DeepLabV3), the first window's
    block grids (K1's first warp of a chain, then K2's 23 steps from K1's
    output) and the identity grid (K1's key-map resample,
    align_corners=True)."""
    flush = L2Flush(device)
    cpm = sleep_cycles_per_ms()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(k1_shape, generator=g).to(device, torch.bfloat16)
    mvs, dg = main_path_grids(device)
    grid, grids = mvs[0], mvs[1:]
    y0 = grid_sample_cuda(x, grid, False)
    # the library call takes NCHW data, and grids of the data's dtype
    xn = x.permute(0, 3, 1, 2).contiguous()
    grid_l, dg_l = grid.to(x.dtype), dg.to(x.dtype)

    def k1(g, g_l, align):
        return time_k1(x, xn, g, g_l, align, flush, cpm)

    res = {
        "grid_sample_cuda": k1(grid, grid_l, False),
        "grid_sample_cuda (identity grid, align_corners=True)": k1(dg, dg_l, True),
        "warp_chain_cuda": time_k2(y0, grids, flush, cpm),
    }
    log_timing(res)
    return res


def time_k1(x, xn, g, g_l, align, flush, cpm) -> dict:
    """K1's time on x (NHWC) and grid g beside its bound, its plain
    version's and F.grid_sample's on xn (NCHW) and g_l (x's dtype)."""
    out = grid_sample_cuda(x, g, align)
    # 4 multiplies and 3 adds per output element
    b = bound(k1_bytes(x, g, out, align), 7 * out.numel())
    return {
        "ms": time_ms(lambda: grid_sample_cuda(x, g, align), flush, cpm),
        "plain_ms": time_ms(lambda: grid_sample(x, g, align), flush, cpm),
        "library_ms": time_ms(lambda: F.grid_sample(
            xn, g_l, mode="bilinear", padding_mode="border", align_corners=align),
            flush, cpm),
        "bound_ms": b[0], "bound_by": b[1],
    }


def log_timing(res: dict, library="F.grid_sample") -> None:
    for name, r in res.items():
        split = ", ".join(f"{k} {v:.2f}" for k, v in r.get("split_us", {}).items())
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"{library} {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) -> {r['bound_ms'] / r['ms']:.1%} of bound"
            + (f"; device us a call by kernel {split}" if split else ""))


def time_k2(y0, grids, flush, cpm, full=True) -> dict:
    """K2's time on y0 and grids beside its bound (y0 and the grids read
    once, every step written once; 4 multiplies and 3 adds per element of
    a step); with ``full``, also its plain version's and the library
    yardstick's: T chained F.grid_sample calls on NCHW data."""
    out = warp_chain_cuda(y0, grids)
    b = bound(nbytes(y0, grids, out), 7 * (out.numel() - y0.numel()))
    r = {"ms": time_ms(lambda: warp_chain_cuda(y0, grids), flush, cpm),
         "bound_ms": b[0], "bound_by": b[1]}
    if full:
        y0n = y0.permute(0, 3, 1, 2).contiguous()
        grids_l = grids.to(y0.dtype)

        def lib_chain():
            y = y0n
            for i in range(grids.shape[0]):
                y = F.grid_sample(y, grids_l[i], mode="bilinear", padding_mode="border",
                                  align_corners=False)
            return y

        r["plain_ms"] = time_ms(lambda: warp_chain_plain(y0, grids), flush, cpm, reps=5)
        r["library_ms"] = time_ms(lib_chain, flush, cpm, reps=10)
    return r


# -------------------------------------------------------------------- K3

PAD1 = ((1, 1), (1, 1))
FEAT_HW = (65, 65)


def k3_compare(name, got, ref) -> float:
    """K3 against its plain version: the int8 outputs must be equal."""
    diff = (got.int() - ref.int()).abs()
    err = float(diff.max())
    share = float((diff != 0).float().mean())
    log(f"  {name}: max_abs_err {err:.0f} on {share:.2e} of lanes (tol 0) -> "
        f"{'ok' if err == 0 else 'FAIL'}")
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version by {err}")
    return err


def finite_bf16_values(device) -> torch.Tensor:
    """Every finite bf16 bit pattern (65,280 values), as (1, 1, 4080, 16)."""
    v = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    v = v[torch.isfinite(v.float())]
    return v.reshape(1, 1, -1, 16).to(device)


def check_k3(stack, scale, seed=0, feat_hw=FEAT_HW, every=True) -> dict:
    """Phase 3a for K3, float32 and bf16: the main path's first-window stack
    at its own scale, random data in both align modes at the same shape and
    at an odd shape with C = 37 (one channel a thread), every case again at
    a fiftieth of its scale (most lanes saturate); then every finite bf16
    value through an identity resize (out_hw equal to the input's), at the
    stack's scale, a fiftieth of it, FLT_MIN and 2**-7 (many values on
    half-integers), so each value's quantize is checked on its own
    (``every``; the values do not depend on the stack's shape). Returns the
    largest error by input dtype."""
    g = torch.Generator().manual_seed(seed)
    errs = {}
    every_value = finite_bf16_values(stack.device)
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, device=stack.device)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cases = [("main-path stack", stack.to(dtype), scale, feat_hw, True)]
        for shape, hw in ((tuple(stack.shape), feat_hw), ((3, 6, 5, 37), (11, 9))):
            x = (torch.randn(shape, generator=g) * 3).to(stack.device, dtype)
            s = quant.scale_from_absmax(x.float().abs().amax())
            cases += [("random", x, s, hw, align) for align in (True, False)]
        for what, x, s, hw, align in cases:
            for sc, sat in ((s, ""), (s / 50, ", saturating")):
                note_err(errs, "K3", dtype, k3_compare(
                    f"K3 {tag} {what} x{tuple(x.shape)} -> {hw} align={align}{sat}",
                    resize_quantize_int8_cuda(x, sc, hw, align),
                    resize_quantize_int8_plain(x, sc, hw, align)))
        if not every:
            continue
        x = every_value.to(dtype)
        hw = tuple(x.shape[1:3])
        for sc, what in ((scale, "the stack's scale"), (scale / 50, "a fiftieth of it"),
                         (tiny, "FLT_MIN"), (torch.full_like(tiny, 2.0 ** -7), "2**-7")):
            note_err(errs, "K3", dtype, k3_compare(
                f"K3 {tag} every finite bf16 value x{tuple(x.shape)} -> {hw} (identity), "
                f"scale {what}", resize_quantize_int8_cuda(x, sc, hw, True),
                resize_quantize_int8_plain(x, sc, hw, True)))
    return errs["K3"]


def time_k3(stack, scale, feat_hw=FEAT_HW) -> dict:
    """Phase 3b for K3 on the main path's first-window stack."""
    flush = L2Flush(stack.device)
    cpm = sleep_cycles_per_ms()
    out = resize_quantize_int8_cuda(stack, scale, feat_hw, True)
    b, _, w, c = stack.shape
    # per output element: the W blend (2 multiplies, 1 add), the divide, the
    # round and the clip; per H-interpolated value: 2 multiplies and 1 add
    flops = 6 * out.numel() + 3 * b * feat_hw[0] * w * c
    bd = bound(nbytes(stack, scale, out), flops)
    xn = stack.permute(0, 3, 1, 2)  # NCHW view of the NHWC (channels-last) stack

    def library():  # two calls: PyTorch has no fused resize + quantize
        y = F.interpolate(xn, size=feat_hw, mode="bilinear", align_corners=True)
        return quant.quantize_with_scale(y.permute(0, 2, 3, 1), scale)

    r = {"ms": time_ms(lambda: resize_quantize_int8_cuda(stack, scale, feat_hw, True),
                       flush, cpm),
         "plain_ms": time_ms(lambda: resize_quantize_int8_plain(stack, scale, feat_hw, True),
                             flush, cpm, reps=5),
         "library_ms": time_ms(library, flush, cpm, reps=10),
         "bound_ms": bd[0], "bound_by": bd[1]}
    log(f"  resize_quantize_int8_cuda x{tuple(stack.shape)} {stack.dtype} -> int8 "
        f"{tuple(out.shape)}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"F.interpolate + quantize {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}) -> {r['bound_ms'] / r['ms']:.1%} of bound")
    return r


def capture_k3_input(model, wins, dev, n=FRAME_DELTA, size=SIZE, frame_hw=(512, 512),
                     feat_hw=FEAT_HW, channels=4096):
    """The interpolated stack and scale that an int8 main path gives K3 in
    its first window, recorded on the way through the full program."""
    full, _ = make_cached_flow_predict_fn(
        model, n=n, out_size=(size, size), default_grid=default_grid(*frame_hw),
        int8_decode=True, device=dev)
    seen = {}
    kernel = flow_model.resize_quantize_int8_cuda

    def recording(x, scale, out_hw, align_corners=True):
        seen.update(x=x.clone(), scale=scale.clone(), out_hw=tuple(out_hw),
                    align=align_corners)
        return kernel(x, scale, out_hw, align_corners)

    flow_model.resize_quantize_int8_cuda = recording
    try:
        w = wins[0]
        full(model.state_dict(), w["frame_prev"], w["frame_next"], w["mvs_left"],
             w["mvs_right"])
    finally:
        flow_model.resize_quantize_int8_cuda = kernel
    sync(torch.device(dev))
    grid_hw = tuple(wins[0]["mvs_left"].shape[2:4])
    if (seen.get("out_hw") != tuple(feat_hw) or seen["align"] is not True
            or tuple(seen["x"].shape) != (n - 1,) + grid_hw + (channels,)):
        raise AssertionError(f"K3's main-path input is not as expected: "
                             f"{ {k: getattr(v, 'shape', v) for k, v in seen.items()} }")
    log(f"  K3's input in the first int8 window: {tuple(seen['x'].shape)} "
        f"{seen['x'].dtype}, scale {float(seen['scale']):.6e}")
    return seen["x"], seen["scale"]


def check_int8_decode_card_vs_cpu(model, shape=(2, 33, 33, 4096), seed=2) -> None:
    """Phase 4b: the same int8 input and int8 weights give equal int32
    accumulators on the card and the CPU; int8_seghead_decode's bf16 logits
    (each device folding and quantizing the head itself) agree within 2
    bf16 ulps of their largest magnitude: the 1x1 conv sums in another order
    before its bf16 rounding, and a one-ulp rsqrt difference in the fold can
    move an int8 weight by one step."""
    g = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    absmax = torch.tensor(4.0)
    head = model.cls.state_dict()
    head_cpu = {k: v.cpu() for k, v in head.items()}

    def qweights(h):
        w_f, _ = quant.fold_bn(h["0.weight"], h["1.weight"], h["1.bias"],
                               h["1.running_mean"], h["1.running_var"])
        return quant.quantize_weight_per_channel(w_f)[0]

    w_q = qweights(head_cpu)
    t0 = time.perf_counter()
    acc_cpu = quant.conv_int8(x_q, w_q, PAD1)
    t1 = time.perf_counter()
    acc_card = quant.conv_int8(x_q.cuda(), w_q.cuda(), PAD1).cpu()
    same = torch.equal(acc_cpu, acc_card)
    log(f"  conv_int8 {tuple(x_q.shape)} x {tuple(w_q.shape)} -> int32 "
        f"{tuple(acc_cpu.shape)}: card {'equals' if same else 'DIFFERS FROM'} CPU "
        f"(CPU {t1 - t0:.3f} s)")
    if not same:
        raise AssertionError("int32 accumulators differ between card and CPU")
    flips = int((qweights(head).cpu() != w_q).sum())
    ref = quant.int8_seghead_decode(head_cpu, x_q, torch.bfloat16, act_absmax=absmax)
    got = quant.int8_seghead_decode(head, x_q.cuda(), torch.bfloat16,
                                    act_absmax=absmax.cuda()).cpu()
    scale = float(ref.float().abs().max())
    tol = scale * 2.0 ** -6
    err = float((got.float() - ref.float()).abs().max())
    log(f"  int8_seghead_decode bf16 logits {tuple(ref.shape)}: max_abs_err {err:.3e}, "
        f"tol {tol:.3e} (2 bf16 ulps at max|logit| {scale:.3e}); {flips} of "
        f"{w_q.numel()} int8 weights differ between the devices' folds")
    if not err <= tol:
        raise AssertionError(f"int8 decode logits differ between card and CPU: {err}")


def check_int8_deeplab_decode_card_vs_cpu(model, shape=(2, 33, 33, 2048), seed=2,
                                          share=2e-2) -> None:
    """Phase 4e: int8_deeplab_decode on the CPU with every conv_int8 call
    recorded; each call replayed on the card from the CPU's int8 input and
    weights must give the CPU's int32 accumulator (the dilated branches at
    rates 12, 24 and 36, the projection, the trailing 3x3). The whole
    decode's bf16 logits, each device folding and quantizing the head
    itself, within ``share`` of their largest magnitude: an int8 weight one
    step apart between the devices' folds moves a lane of the concat or the
    projection, at their dynamic scales."""
    g = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    absmax = torch.tensor(4.0)
    head_cpu = {k: v.cpu() for k, v in model.classifier.state_dict().items()}
    head = {k: v.cuda() for k, v in head_cpu.items()}
    calls, conv = [], quant.conv_int8

    def recording(x, w, padding, dilation=(1, 1), strides=(1, 1)):
        acc = conv(x, w, padding, dilation, strides)
        calls.append((x, w, padding, dilation, acc))
        return acc

    quant.conv_int8 = recording
    try:
        ref = quant.int8_deeplab_decode(head_cpu, x_q, torch.bfloat16, act_absmax=absmax)
    finally:
        quant.conv_int8 = conv
    if [c[3] for c in calls] != [(1, 1), (12, 12), (24, 24), (36, 36), (1, 1), (1, 1)]:
        raise AssertionError(f"unexpected int8 convs: {[c[3] for c in calls]}")
    for x, w, padding, dilation, acc in calls:
        got = quant.conv_int8(x.cuda(), w.cuda(), padding, dilation).cpu()
        same = torch.equal(got, acc)
        log(f"  conv_int8 {tuple(x.shape)} x {tuple(w.shape)} dilation {dilation} -> "
            f"int32 {tuple(acc.shape)}: card {'equals' if same else 'DIFFERS FROM'} CPU")
        if not same:
            raise AssertionError("int32 accumulators differ between card and CPU")
    got = quant.int8_deeplab_decode(head, x_q.cuda(), torch.bfloat16,
                                    act_absmax=absmax.cuda()).cpu()
    scale = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    log(f"  int8_deeplab_decode bf16 logits {tuple(ref.shape)}: max_abs_err {err:.3e} "
        f"({err / scale:.2e} of max|logit| {scale:.3e}), tol {share:g} x")
    if not err <= share * scale:
        raise AssertionError(f"int8 DeepLab decode logits differ between card and CPU: {err}")


# ------------------------------------------------------------- the slice

def random_model(arch, dtype, seed=0, image_size=DL_SIZE, with_aux=False, layers=50,
                 remat=False):
    """PSPNet or DeepLabV3 with a ResNet-``layers`` trunk (with the aux head
    if ``with_aux``; every bottleneck rematerialised in training if
    ``remat``), or ViT-B/32 for ``image_size`` px frames, with weights from
    one torch.Generator seed, every BN's statistics and every LayerNorm
    perturbed."""
    model = build_model(arch, classes=CLASSES, layers=layers, image_size=image_size,
                        with_aux=with_aux, dtype=dtype, remat=remat)
    return init_from_generator_(model, torch.Generator().manual_seed(seed))


def clip_windows(n, frame_hw, num_windows, size, device, seed=0):
    """In-memory synthetic windows, frames resized to ``size`` on ``device``."""
    clip = synthetic_clip(num_windows * n + 1, size=frame_hw,
                          frame_ids=range(0, num_windows * n + 1, n), seed=seed)
    wins = []
    for w in predict_windows(clip, n):
        wins.append({
            "frame_prev": resize_frames(torch.as_tensor(w["frame_prev"], device=device),
                                        (size, size)),
            "frame_next": resize_frames(torch.as_tensor(w["frame_next"], device=device),
                                        (size, size)),
            "mvs_left": torch.as_tensor(w["mvs_left"], device=device),
            "mvs_right": torch.as_tensor(w["mvs_right"], device=device),
            "prev_frame_id": w["prev_frame_id"],
            "next_frame_id": w["next_frame_id"],
        })
    return wins


def window_logits(model, w, n, dg, size, device, int8=False, int8_encode=False):
    """Logits (n, size, size, classes) of one window through the
    interpolator with the builders' encoder and decoder, frames normalised
    as the predict builders do; ``int8`` decodes with the model's int8 head
    at the key encodings' absmax hint, ``int8_encode`` encodes with the
    int8 trunk."""
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    interp = FlowInterpolator(_predict_encode(model, int8_encode), _predict_decode(model, int8),
                              decode_wants_absmax=int8, decode_split=decode_split_ok(model))
    with torch.inference_mode():
        return interp.predict_clip(
            (w["frame_prev"].float() - mean) / std,
            (w["frame_next"].float() - mean) / std,
            w["mvs_left"], w["mvs_right"], n,
            default_grid=torch.as_tensor(dg, device=device), out_size=(size, size))


def slice_outputs(model, device, n, size, frame_hw, wins, int8, int8_encode=False):
    """Logits of window 0 through the interpolator, and the int32 maps and
    next encodings of the full program (window 0) and the cached program
    (window 1) through make_cached_flow_predict_fn."""
    dg = default_grid(*frame_hw)
    full, cached = make_cached_flow_predict_fn(
        model, n=n, out_size=(size, size), default_grid=dg, int8_decode=int8,
        int8_encode=int8_encode, device=device)
    variables = model.state_dict()
    w0, w1 = (  # the builders take raw frames; the interpolator normalised ones
        {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in w.items()}
        for w in wins[:2])
    logits = window_logits(model, w0, n, dg, size, device, int8, int8_encode)
    maps0, enc0 = full(variables, w0["frame_prev"], w0["frame_next"],
                       w0["mvs_left"], w0["mvs_right"])
    maps1, enc1 = cached(variables, enc0, w1["frame_next"], w1["mvs_left"],
                         w1["mvs_right"])
    return {k: (v.float() if v.is_floating_point() else v).cpu()
            for k, v in dict(logits=logits, maps0=maps0, enc0=enc0, maps1=maps1,
                             enc1=enc1).items()}


# card against CPU, share of the logits' largest magnitude, by the slice's
# arch and decoder ("float32", "int8" on a float32 model, "bfloat16"): float32
# through ~55 layers in different summation orders agrees to 1e-4. With an int8
# head, a value that the two devices' float32 encoders put on either side
# of a rounding boundary is quantized one step apart: the SegHead's one
# quantization moves nearby logits by about 1e-3 of their scale; the
# DeepLabHead quantizes three times (the input, the ASPP concat, the
# projection), and each one-step lane moves many values of the next map
# (on the CPU against JAX: 0.7% of the scale, tests/test_torch_flow_deeplabv3.py;
# on an H100 80GB HBM3, 700 W, card against CPU: 2.53%). The ViT's float32
# logits, after 14 transformer blocks and a LayerNorm over the 5 classes,
# are held to the CNNs' 1e-4 (on the CPU against JAX at 64 px: 4.9e-5 at
# most, tests/test_torch_flow_vit.py). In bf16 the ViT rounds the same
# operations in the same order on both devices, but float32 sums inside a
# rounding differ, so a value near a bf16 boundary lands one ulp apart and
# the next layers carry it on: the bounds of ViT-B/32 in bf16 against JAX
# on the CPU (tests/test_torch_vit.py::test_full_width_vit_b32_bf16_matches_jax,
# 64 px), 24 bf16 ulps (2**-8 of the largest magnitude each) for the logits
# and 8 for the encoder's token map (9.92 and 4.11 measured there).
SLICE_TOL = {("pspnet", "float32"): 1e-4, ("pspnet", "int8"): 2e-3,
             ("deeplabv3", "float32"): 1e-4, ("deeplabv3", "int8"): 5e-2,
             ("vit", "float32"): 1e-4, ("vit", "bfloat16"): 24 * 2.0 ** -8}
ENC_TOL = {"float32": 1e-4, "int8": 1e-4, "bfloat16": 8 * 2.0 ** -8}
SLICE_FRAME_HW = (128, 128)  # the clip's frames; key frames resized to ``size``


class Int8Calls:
    """Records every conv_int8 call in the block: its operands, geometry
    and int32 accumulator, on the host."""

    def __enter__(self):
        self.calls, self.conv = [], quant.conv_int8

        def recording(x_q, w_q, padding, dilation=(1, 1), strides=(1, 1)):
            acc = self.conv(x_q, w_q, padding, dilation, strides)
            self.calls.append((x_q.cpu(), w_q.cpu(), padding, tuple(dilation),
                               tuple(strides), acc.cpu()))
            return acc

        quant.conv_int8 = recording
        return self

    def __exit__(self, *exc):
        quant.conv_int8 = self.conv


def lanes_off(a, b):
    """(share of lanes where int8 maps a and b differ, largest difference)."""
    d = (a.int() - b.int()).abs()
    return float((d != 0).float().mean()), int(d.max())


def check_slice_card_vs_cpu(arch="pspnet", n=5, size=129, seed=1, int8=False,
                            dtype=torch.float32) -> None:
    """Phases 4, 4d and 4v: a float32 model (TF32 off) or a bf16 one (bf16
    products reduced in float32), the same weights and inputs on both,
    logits within SLICE_TOL and the key encodings within ENC_TOL of their
    largest magnitude; the maps equal away from near-ties. Key frames of
    ``size`` px from a clip of SLICE_FRAME_HW frames."""
    mode = "int8" if int8 else str(dtype).split(".")[-1]
    cpu_model = random_model(arch, dtype, seed, image_size=size)
    gpu_model = copy.deepcopy(cpu_model)
    wins = clip_windows(n, SLICE_FRAME_HW, 2, size, "cpu", seed)
    matmul = torch.backends.cuda.matmul
    with full_precision_f32():
        log(f"  {mode} decoder; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={matmul.allow_tf32} cuda.matmul."
            f"allow_bf16_reduced_precision_reduction="
            f"{matmul.allow_bf16_reduced_precision_reduction}")
        t0 = time.perf_counter()
        with Int8Calls() as ref_calls:
            ref = slice_outputs(cpu_model, torch.device("cpu"), n, size, SLICE_FRAME_HW,
                                wins, int8)
        t1 = time.perf_counter()
        with Int8Calls() as got_calls:
            got = slice_outputs(gpu_model, torch.device("cuda"), n, size, SLICE_FRAME_HW,
                                wins, int8)
        torch.cuda.synchronize()
    log(f"  cpu {t1 - t0:.1f} s, card {time.perf_counter() - t1:.1f} s")
    if int8:
        # each decode call's int8 maps, by where they were quantized
        per_call = 6 if arch == "deeplabv3" else 1
        names = (("input", "input", "input", "input", "concat", "projection")
                 if arch == "deeplabv3" else ("input",))
        worst = {}
        for i, ((a, *_), (b, *_)) in enumerate(zip(got_calls.calls, ref_calls.calls)):
            share, step = lanes_off(a, b)
            k = names[i % per_call]
            worst[k] = max(worst.get(k, (0.0, 0)), (share, step))
        log(f"  int8 maps card vs CPU over {len(ref_calls.calls)} convs, the largest share "
            f"of lanes off and step by quantization: {worst}")
    scale = float(ref["logits"].abs().max())
    share = SLICE_TOL[(arch, mode)]
    tol = share * scale
    err = float((got["logits"] - ref["logits"]).abs().max())
    log(f"  logits {tuple(ref['logits'].shape)}: max_abs_err {err:.3e} "
        f"({err / scale:.2e} of max|logit| {scale:.3e}; {err / scale / 2.0 ** -8:.2f} "
        f"bf16 ulps of it), tol {tol:.3e} ({share:g} x)")
    if not err <= tol:
        raise AssertionError(f"card and CPU logits disagree: {err} > {tol}")
    if dtype == torch.bfloat16:
        # the reading with PyTorch's default, bf16 partial sums allowed (the
        # block restores the flag on exit)
        w0 = {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in wins[0].items()}
        with full_precision_f32():
            matmul.allow_bf16_reduced_precision_reduction = True
            loose = window_logits(gpu_model, w0, n, default_grid(*SLICE_FRAME_HW), size,
                                  torch.device("cuda")).float().cpu()
        e = float((loose - ref["logits"]).abs().max())
        log(f"  logits with allow_bf16_reduced_precision_reduction=True: max_abs_err "
            f"{e:.3e} ({e / scale / 2.0 ** -8:.2f} bf16 ulps of max|logit|; reading only)")
    for k in ("enc0", "enc1"):
        s = float(ref[k].abs().max())
        e = float((got[k] - ref[k]).abs().max())
        etol = ENC_TOL[mode] * s
        log(f"  {k} {tuple(ref[k].shape)}: max_abs_err {e:.3e} ({e / s:.2e} of "
            f"max|enc| {s:.3e}), tol {etol:.3e}")
        if not e <= etol:
            raise AssertionError(f"card and CPU {k} disagree: {e}")
    # maps: equal wherever the top-2 gap of the CPU logits exceeds the
    # logits tolerance (window 0 logits are the full program's)
    top2 = ref["logits"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
    same = (got["maps0"] == ref["maps0"])
    log(f"  maps0: {float(same.float().mean()):.6f} equal, "
        f"{int((~same & clear).sum())} differ away from near-ties "
        f"({float(clear.float().mean()):.4f} of pixels clear)")
    if bool((~same & clear).any()):
        raise AssertionError("card and CPU maps differ away from near-ties")
    same1 = float((got["maps1"] == ref["maps1"]).float().mean())
    log(f"  maps1 (cached window): {same1:.6f} equal")
    if same1 < (0.999 if mode == "float32" else 0.99):
        raise AssertionError(f"cached-window maps agree on only {same1:.6f}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_main_path(model, wins, int8, tag, dev=torch.device("cuda"), n=FRAME_DELTA,
                  size=SIZE, frame_hw=(512, 512), int8_encode=False) -> dict:
    """Phases 5 to 9 and 24b: a bf16 model (PSPNet-50 at 513 px,
    DeepLabV3-50 and ViT-B/32 at 512 px), n = 25, bench.py's protocol,
    with the full-precision or the int8 decoder, and the full-precision or
    (``int8_encode``, bench.py --int8-enc) the int8 encoder."""
    full, cached = make_cached_flow_predict_fn(
        model, n=n, out_size=(size, size), default_grid=default_grid(*frame_hw),
        int8_decode=int8, int8_encode=int8_encode, device=dev)
    variables = model.state_dict()
    state = {"feat": None, "next_id": None, "windows": 0}

    def run(w, first=False):
        if first or state["feat"] is None or w["prev_frame_id"] != state["next_id"]:
            out, feat = full(variables, w["frame_prev"], w["frame_next"],
                             w["mvs_left"], w["mvs_right"])
        else:
            out, feat = cached(variables, state["feat"], w["frame_next"],
                               w["mvs_left"], w["mvs_right"])
        state["feat"], state["next_id"] = feat, w["next_frame_id"]
        state["windows"] += 1
        return out

    timed = wins[1:1 + CLIPS_TIMED]
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    run(wins[0], first=True)
    run(wins[1])
    out = run(wins[0], first=True)
    sync(dev)
    log(f"  warm-up (3 windows): {time.perf_counter() - t0:.2f} s")
    fps = []
    for p in range(PASSES):
        t0 = time.perf_counter()
        for w in timed:
            out = run(w)
        sync(dev)
        fps.append(len(timed) * n / (time.perf_counter() - t0))
        log(f"  pass {p + 1}/{PASSES}: {fps[-1]:.2f} frames/s")
    counts = launch_counts()
    windows = state["windows"]
    log(f"  launches over {windows} windows: {counts}")
    per_window = {"grid_sample_cuda": 3, "grid_sample_backward_cuda": 0, "warp_chain_cuda": 2,
                  "resize_quantize_int8_cuda": 1 if int8 else 0}
    expected = {k: v * windows if dev.type == "cuda" else 0 for k, v in per_window.items()}
    if counts != expected:
        raise AssertionError(f"the main path did not go through the kernels as "
                             f"expected per window: {counts}, expected {expected}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0

    if out.shape != (n, size, size) or out.dtype != torch.int32:
        raise AssertionError(f"maps {tuple(out.shape)} {out.dtype}")
    lo, hi = int(out.min()), int(out.max())
    if lo < 0 or hi >= CLASSES:
        raise AssertionError(f"class ids outside [0, {CLASSES}): {lo}..{hi}")
    if not bool(torch.isfinite(state["feat"]).all()):
        raise AssertionError("non-finite next-key encoding")
    # logits of one window (outside the counted run): finite, expected shape
    logits = window_logits(model, timed[0], n, default_grid(*frame_hw), size, dev, int8,
                           int8_encode)
    if logits.shape != (n, size, size, CLASSES) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or misshapen")
    log(f"  maps {tuple(out.shape)} int32 in [{lo}, {hi}], logits "
        f"{tuple(logits.shape)} {logits.dtype} finite, peak memory {peak_gb:.2f} GB")

    prof = profile(run, timed, tag) if dev.type == "cuda" else {}
    return {"fps": statistics.median(fps), "fps_passes": fps, "windows": windows,
            "launches": counts, "peak_gb": peak_gb, "maps": out, **prof}


PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
KERNEL_NAMES = {"grid_sample_cuda": "grid_sample_kernel",
                "grid_sample_backward_cuda": "grid_sample_backward_",  # index and gather
                "warp_chain_cuda": "warp_chain_",  # either design
                "resize_quantize_int8_cuda": "resize_quantize_kernel"}
# a window's device time by family of kernel names; the first family whose
# pattern a name contains takes it (cuDNN's implicit-GEMM convolutions
# before the matrix products, the casts before the other elementwise work)
KERNEL_FAMILIES = (
    ("K1-K3", tuple(KERNEL_NAMES.values())),
    ("convolutions", ("fprop", "cudnn")),
    ("matrix products", ("gemm", "nvjet", "cutlass")),
    ("copies and casts", ("copy", "CatArray")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce_kernel",)),
    ("other elementwise", ("",)),
)


def kernel_families(kernels, windows=2) -> dict:
    """ms a window of each KERNEL_FAMILIES family over trace kernel events."""
    ms = {name: 0.0 for name, _ in KERNEL_FAMILIES}
    for e in kernels:
        family = next(name for name, pats in KERNEL_FAMILIES
                      if any(p in e["name"] for p in pats))
        ms[family] += e["dur"] / (1e3 * windows)
    return ms


def profile(run, timed, tag) -> dict:
    """torch.profiler over two cached windows: device busy time and idle
    share per window, each kernel's time per window, kernel time by name."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    os.makedirs(PROFILE_DIR, exist_ok=True)
    run(timed[0], first=True)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for w in timed[1:3]:
            run(w)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(PROFILE_DIR, f"{tag}_main_path_profile.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(PROFILE_DIR, f"{tag}_main_path_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy = union_us(spans)
    span = max(e for _, e in spans) - spans[0][0]
    per_kernel = {k: sum(e["dur"] for e in kernels if v in e["name"]) / 2e3
                  for k, v in KERNEL_NAMES.items()}
    families = kernel_families(kernels)
    log(f"  profiler, 2 cached windows: device busy {busy / 2e3:.3f} ms/window "
        f"of {span / 2e3:.3f} ms (idle share {1 - busy / span:.1%} under the "
        f"profiler); ms/window by kernel {per_kernel}; table and trace in "
        f"{PROFILE_DIR}")
    log(f"  {len(kernels) / 2:.0f} kernels a window; ms/window by family "
        f"{ {k: round(v, 3) for k, v in families.items()} }")
    log(table)
    return {"busy_ms": busy / 2e3, "span_ms": span / 2e3, "kernel_ms": per_kernel,
            "family_ms": families}


def time_int8_conv(name, x_q, w_q, padding, dilation, flush, cpm) -> dict:
    """One int8 conv's two pieces at its path's shape, CUDA events with the
    L2 flushed: the im2col copy and torch._int_mm, the GEMM beside its bound
    at the int8 peak."""
    k = w_q.shape[-1]
    w_mat = w_q.permute(0, 2, 3, 1).reshape(w_q.shape[0], -1).t()
    cols, _ = quant.im2col_nhwc(x_q, k, k, padding, dilation)
    m, kk = cols.shape
    r = {"im2col_ms": time_ms(lambda: quant.im2col_nhwc(x_q, k, k, padding, dilation),
                              flush, cpm, reps=10),
         "int_mm_ms": time_ms(lambda: torch._int_mm(cols, w_mat), flush, cpm, reps=10),
         "im2col_bytes": cols.numel() + x_q.numel(),
         "int_mm_tops": 2 * m * kk * w_mat.shape[1] / 1e12}
    r["int_mm_bound_ms"] = r["int_mm_tops"] * 1e12 / PEAK_INT8_OPS * 1e3
    log(f"  {name} {tuple(x_q.shape)} -> {w_q.shape[0]}: im2col {r['im2col_ms']:.4f} ms "
        f"({r['im2col_bytes'] / 1e9:.3f} GB moved at least), _int_mm "
        f"{r['int_mm_ms']:.4f} ms ({r['int_mm_tops']:.3f} TOP, bound "
        f"{r['int_mm_bound_ms']:.4f} ms at the int8 peak)")
    return r


def random_int8(shape, g, dev):
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)


def time_decode_pieces(model, n=FRAME_DELTA) -> dict:
    """Phase 6b: the int8 SegHead's pieces at the main path's shapes (the
    key map, 1x65x65x4096, and the stack, 24x65x65x4096): its conv's im2col
    and torch._int_mm, and the whole decode (weights folded and quantized,
    the epilogue and the 1x1 conv included), CUDA events, L2 flushed."""
    dev = torch.device("cuda")
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    head = model.cls.state_dict()
    w_f, _ = quant.fold_bn(head["0.weight"], head["1.weight"], head["1.bias"],
                           head["1.running_mean"], head["1.running_var"])
    w_q, _ = quant.quantize_weight_per_channel(w_f)
    g = torch.Generator().manual_seed(3)
    absmax = torch.tensor(4.0, device=dev)
    res = {}
    for name, b in (("key map", 1), ("stack", n - 1)):
        x_q = random_int8((b,) + FEAT_HW + (4096,), g, dev)
        r = res[name] = time_int8_conv(f"the {name}'s 3x3", x_q, w_q, PAD1, (1, 1),
                                       flush, cpm)
        r["decode_ms"] = time_ms(lambda: quant.int8_seghead_decode(
            head, x_q, torch.bfloat16, act_absmax=absmax), flush, cpm, reps=10)
        log(f"  whole decode of the {name}: {r['decode_ms']:.4f} ms")
    return res


def time_deeplab_decode_pieces(model, n=FRAME_DELTA, feat_hw=DL_FEAT_HW) -> dict:
    """Phase 8b: the int8 DeepLabHead's pieces at the main path's shape (one
    decode call of n x 64x64x2048): each int8 conv's im2col and
    torch._int_mm, and the whole decode (weights folded and quantized, the
    pooling branch, the epilogues and the 1x1 classifier included), CUDA
    events, L2 flushed."""
    dev = torch.device("cuda")
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    head = model.classifier.state_dict()
    g = torch.Generator().manual_seed(3)
    convs = [("ASPP 1x1", "0.convs.0", 2048, 0)] + [
        (f"ASPP 3x3 rate {r}", f"0.convs.{i}", 2048, r)
        for i, r in enumerate((12, 24, 36), 1)] + [
        ("projection 1x1", "0.project", 1280, 0), ("head 3x3", "", 256, 1)]
    res = {}
    for name, key, cin, r in convs:
        conv, bn = (f"{key}.0", f"{key}.1") if key else ("1", "2")
        w_q, _, _ = quant._fold_quant(head, conv, bn, 1e-5)
        x_q = random_int8((n,) + tuple(feat_hw) + (cin,), g, dev)
        res[name] = time_int8_conv(name, x_q, w_q, ((r, r), (r, r)),
                                   (r, r) if r else (1, 1), flush, cpm)
        del x_q
    x_q = random_int8((n,) + tuple(feat_hw) + (2048,), g, dev)
    absmax = torch.tensor(4.0, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    decode_ms = time_ms(lambda: quant.int8_deeplab_decode(
        head, x_q, torch.bfloat16, act_absmax=absmax), flush, cpm, reps=5)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    log(f"  whole int8_deeplab_decode of {tuple(x_q.shape)}: {decode_ms:.4f} ms, "
        f"{peak_gb:.2f} GB above its input at peak")
    return res


# ------------------------------------------- from files: phases 3c, 10-12

FRAME_HW = (1072, 1920)  # the reference's frames (core/config.py resize)
CROP = 433               # PSPNet's train size, the CLI's default test crop
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "data")


def crop_route_grids(device, n=FRAME_DELTA, crop=CROP, frame_hw=FRAME_HW):
    """The grids phase 12 gives the kernels in its first window's first
    crop (offset (0, 0)): mvs_left renormalized to the crop, (n-1, 1, 27,
    27, 2), and the full-frame identity grid (1, 67, 120, 2) of the key-map
    resample. The in-memory clip has the tree's grids (the same motion)."""
    clip = synthetic_clip(n + 1, size=frame_hw, frame_ids=(), seed=0)
    ml = crop_motion_vectors_stack_np(clip["grids"][1:n], *frame_hw, crop, crop, 0, 0)
    return (torch.as_tensor(ml[:, None], device=device).contiguous(),
            torch.as_tensor(default_grid(*frame_hw), device=device)[None].contiguous())


def crop_feature_hw(model, device, crop=CROP):
    """The encoding's size of a crop, from the model itself."""
    with torch.inference_mode():
        f = model.encode(torch.zeros((1, crop, crop, 3), device=device))[0]
    return tuple(f.shape[1:3]), f.shape[3]


def check_crop_kernels(model, dev) -> tuple:
    """Phase 3c: K1 (1, 55, 55, 4096) -> 27x27 on the crop route's own
    first-window grid, K1 -> the 67x120 full-frame identity grid
    (align_corners=True, an up-sample) and onto a 67x120 grid clamped to one
    corner, K2 23 steps on (1, 27, 27, 4096) from K1's output; float32 and
    bf16 against the plain versions (K1 and K2 bit-equal),
    then bf16 timed beside bound and F.grid_sample."""
    feat_hw, c = crop_feature_hw(model, dev)
    log(f"  PSPNet-50 encodes a {CROP} px crop to {feat_hw + (c,)}")
    ml, dg = crop_route_grids(dev)
    geo = _chain_geometry(ml.shape[2] * ml.shape[3], c, 2, 8)
    log(f"  K2 at {ml.shape[2]}x{ml.shape[3]} points, C = {c} bf16: "
        f"{'ping-pong' if geo.table_points else 'single-buffer'} design, "
        f"{geo.c_tile}-channel tile, {geo.table_points} table point(s) a thread, "
        f"{c // geo.c_tile} blocks of {geo.threads} threads, {geo.smem} B shared memory")
    errs = {}
    g = torch.Generator().manual_seed(0)
    xs = torch.randn((1,) + feat_hw + (c,), generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        x = xs.to(dev, dtype)
        for grid, align, what in ((ml[0], False, "crop chain head"),
                                  (dg, True, "full-frame identity"),
                                  (torch.full_like(dg, -1.5), True, "full-frame corner")):
            note_err(errs, "grid_sample_cuda", dtype, check_k1(
                f"K1 {tag} x{tuple(x.shape)} {what} grid{tuple(grid.shape)} align={align}",
                x, grid, align))
        y0 = grid_sample(x, ml[0], False)
        note_err(errs, "warp_chain_cuda", dtype, check_bits(
            f"K2 {tag} y0{tuple(y0.shape)} crop grids T={ml.shape[0] - 1} ({k2_design(y0)})",
            warp_chain_cuda(y0, ml[1:]), warp_chain_plain(y0, ml[1:])))
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    x = xs.to(dev, torch.bfloat16)
    xn = x.permute(0, 3, 1, 2).contiguous()
    y0 = grid_sample_cuda(x, ml[0], False)
    res = {
        "grid_sample_cuda (crop -> 27x27)": time_k1(x, xn, ml[0], ml[0].to(x.dtype), False,
                                                   flush, cpm),
        "grid_sample_cuda (crop -> 67x120 identity, align_corners=True)": time_k1(
            x, xn, dg, dg.to(x.dtype), True, flush, cpm),
        "warp_chain_cuda (27x27, 23 steps)": time_k2(y0, ml[1:], flush, cpm),
    }
    log_timing(res)
    return errs, res


def psnr(a, b) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def codec_phase(threads=8, frames=32) -> dict:
    """Phase 10: a 1072x1920 synthetic frame through the port's JPEG
    encoder and decoder at q92; ms a frame on one thread (median of 5) and
    on ``threads`` threads (wall time of ``frames`` calls over their count)."""
    frame = synthetic_clip(1, size=FRAME_HW)["frames"][0]
    data = encode_jpeg(frame, 92)
    back = decode_jpeg(data)
    q = psnr(back, frame)
    log(f"  {FRAME_HW[0]}x{FRAME_HW[1]} q92: {len(data) / 1e3:.1f} kB, round trip "
        f"PSNR {q:.2f} dB (must exceed 35)")
    if not q > 35:
        raise AssertionError(f"JPEG round trip PSNR {q:.2f} dB")
    res = {"psnr_db": q, "jpeg_kb": len(data) / 1e3}
    for what, fn in (("decode", lambda: decode_jpeg(data)),
                     ("encode", lambda: encode_jpeg(frame, 92))):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda _: fn(), range(frames)))
            wall = (time.perf_counter() - t0) * 1e3
        res[f"{what}_ms"] = statistics.median(ts)
        res[f"{what}_ms_{threads}_threads"] = wall / frames
        log(f"  {what}: {res[f'{what}_ms']:.2f} ms a frame on 1 thread, "
            f"{wall / frames:.2f} ms a frame on {threads} threads ({os.cpu_count()} CPUs)")
    return res


def med_ms(fn, args):
    ts = []
    for a in args:
        t0 = time.perf_counter()
        fn(a)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def files_phase(model, dev, n=FRAME_DELTA, size=SIZE) -> dict:
    """Phase 11: bench.py's protocol from files. A 512 px tree from the
    port's writer ((CLIPS_TIMED + 2) windows), read by FlowDataset (JPEG
    decode, resize to 513, raw float32 pixels), DataLoader (8 threads,
    prefetch 4, device_put), PSPNet-50 bf16 through make_cached_flow_predict_fn.
    frames/s with the batches loaded before the timed loop (bench.py:206),
    then with the loader in the loop (--streaming), and the per-stage host
    breakdown (bench.py:390-435)."""
    root = os.path.join(DATA_DIR, "tree_512")
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    generate_synthetic_dataset(root, num_frames=(CLIPS_TIMED + 2) * n + 1, size=(512, 512),
                               frame_delta=n, num_labeled=4)
    log(f"  tree: {(CLIPS_TIMED + 2) * n + 1} frames of 512x512 written in "
        f"{time.perf_counter() - t0:.1f} s")
    ds = FlowDataset("predict", root, type="u", frame_delta=n, predict_v_id="synth",
                     transform=build_test_transform(resize=(size, size), normalize=False))

    def put(b):
        return device_put(b, dev)

    t0 = time.perf_counter()
    batches = list(DataLoader(ds, batch_size=1, num_workers=8, prefetch=4, device_put=put))
    sync(dev)
    log(f"  {len(batches)} windows loaded in {time.perf_counter() - t0:.2f} s: frame_prev "
        f"{tuple(batches[0]['frame_prev'].shape)} {batches[0]['frame_prev'].dtype}, "
        f"mvs_left {tuple(batches[0]['mvs_left'].shape)}")
    full, cached = make_cached_flow_predict_fn(model, n=n, out_size=(size, size),
                                               default_grid=ds.default_grid, device=dev)
    variables = model.state_dict()
    state = {"feat": None, "next_id": None, "windows": 0}

    def run(b, first=False):
        pfid = int(b["prev_frame_id"][0])
        if first or state["feat"] is None or pfid != state["next_id"]:
            out, feat = full(variables, b["frame_prev"], b["frame_next"], b["mvs_left"],
                             b["mvs_right"])
        else:
            out, feat = cached(variables, state["feat"], b["frame_next"], b["mvs_left"],
                               b["mvs_right"])
        state["feat"], state["next_id"] = feat, int(b["next_frame_id"][0])
        state["windows"] += 1
        return out

    reset_launch_counts()
    preloaded = [run(batches[0], first=True), run(batches[1])]
    timed = batches[1:1 + CLIPS_TIMED]
    fps = []
    for _ in range(PASSES):
        sync(dev)
        t0 = time.perf_counter()
        for b in timed:
            out = run(b)
        sync(dev)
        fps.append(len(timed) * n / (time.perf_counter() - t0))
    log(f"  batches loaded before the loop: {statistics.median(fps):.2f} frames/s (median "
        f"of {PASSES} passes x {len(timed)} windows; {[round(f, 2) for f in fps]})")

    streamed = []
    state["feat"] = state["next_id"] = None
    t0 = None
    for i, b in enumerate(DataLoader(ds, batch_size=1, num_workers=8, prefetch=4,
                                     device_put=put)):
        if t0 is None:
            t0 = time.perf_counter()
        out = run(b, first=(i == 0))
        if i < 2:
            streamed.append(out.clone())
    sync(dev)
    streaming_fps = (len(batches) - 1) * n / (time.perf_counter() - t0)
    log(f"  loader in the loop (--streaming): {streaming_fps:.2f} frames/s over "
        f"{len(batches) - 1} windows after the first arrived")
    counts = launch_counts()
    windows = state["windows"]
    expected = {"grid_sample_cuda": 3 * windows, "grid_sample_backward_cuda": 0,
                "warp_chain_cuda": 2 * windows, "resize_quantize_int8_cuda": 0}
    log(f"  launches over {windows} windows: {counts}")
    if counts != expected:
        raise AssertionError(f"the cached route from files launched {counts}, "
                             f"expected {expected}")
    for i in range(2):
        same = torch.equal(streamed[i], preloaded[i])
        log(f"  window {i}: maps from the streaming loader "
            f"{'equal' if same else 'DIFFER FROM'} the preloaded batches' "
            f"{tuple(preloaded[i].shape)}")
        if not same:
            raise AssertionError("maps differ between the streamed and preloaded batches")
    if out.shape != (n, size, size) or int(out.min()) < 0 or int(out.max()) >= CLASSES:
        raise AssertionError(f"maps {tuple(out.shape)} out of range")

    idxs = list(range(min(6, len(ds))))
    bd = {"item_load_ms": med_ms(lambda i: ds.get(i, np.random.default_rng((0, 0, i))), idxs),
          "jpg_decode_ms": med_ms(lambda i: (imread(ds.frame_path("synth", i * n)),
                                             imread(ds.frame_path("synth", (i + 1) * n))),
                                  idxs),
          "grid_npy_ms": med_ms(lambda i: [ds._load_grid("synth", i * n + k + 1, name)
                                           for k in range(n - 1)
                                           for name in ("grids", "inv_grids")], idxs)}
    bd["transform_ms"] = max(0.0, bd["item_load_ms"] - bd["jpg_decode_ms"] - bd["grid_npy_ms"])
    items = [ds.get(i, np.random.default_rng((0, 0, i))) for i in idxs]
    bd["collate_ms"] = med_ms(lambda i: collate([items[i]]), idxs)
    host = [collate([it]) for it in items]

    def put_sync(i):
        put(host[i])
        sync(dev)

    bd["device_put_ms"] = med_ms(put_sync, idxs)
    bd["device_compute_ms_per_window"] = 1000 * n / statistics.median(fps)
    log(f"  host breakdown, ms a window (medians of {len(idxs)}): "
        f"{ {k: round(v, 3) for k, v in bd.items()} }")
    return {"fps": statistics.median(fps), "fps_passes": fps, "streaming_fps": streaming_fps,
            "breakdown": bd, "launches": counts, "windows": windows}


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s0, e0 in sorted(spans):
        if cur is None or s0 > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s0, e0]
        else:
            cur[1] = max(cur[1], e0)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def device_time(trace_path, windows) -> dict:
    """Device busy ms (the union of kernel intervals) and device-to-host
    copy ms a window from a chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"]
    busy = union_us(kernels)
    d2h = sum(e["dur"] for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", ""))
    return {"busy_ms": busy / 1e3 / windows, "d2h_ms": d2h / 1e3 / windows,
            "kernels": len(kernels) / windows}


def crop_route_phase(model, dev, n=FRAME_DELTA) -> dict:
    """Phase 12: the CLI's default predict route at full width through
    run_flow_predict: a 1072x1920 tree of 2n + 1 frames from the port's
    writer (2 windows), 433x433 crops (28 a window), n = 25, PSPNet-50
    bf16, metrics, palette PNGs and the AVI. torch.profiler (CUDA activity)
    over the run gives device busy and the device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    root = os.path.join(DATA_DIR, "tree_1072")
    out_dir = os.path.join(DATA_DIR, "predict_1072")
    for d in (root, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    generate_synthetic_dataset(root, num_frames=2 * n + 1, size=FRAME_HW, frame_delta=n,
                               num_labeled=2)
    log(f"  tree: {2 * n + 1} frames of {FRAME_HW[0]}x{FRAME_HW[1]} written in "
        f"{time.perf_counter() - t0:.1f} s; {len(crop_offsets(*FRAME_HW, CROP, CROP))} "
        f"crops of {CROP} px a window")
    crops = len(crop_offsets(*FRAME_HW, CROP, CROP))
    prof = PhaseProfiler(sync=cuda_sync)
    video = os.path.join(out_dir, "synth.avi")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    os.makedirs(PROFILE_DIR, exist_ok=True)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with tprofile(activities=[activity]) as tp:
        summary = run_flow_predict(model, model.state_dict(), root, "synth", frame_delta=n,
                                   resize=FRAME_HW, crop=(CROP, CROP), no_cropping=False,
                                   save_images_dir=os.path.join(out_dir, "frames"),
                                   video_path=video, profiler=prof, device=dev)
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    windows = summary["frames"] // n
    trace = os.path.join(PROFILE_DIR, "pspnet_bf16_crop_route_trace.json")
    tp.export_chrome_trace(trace)
    dt = device_time(trace, windows)
    log(f"  summary: { {k: (round(v, 4) if isinstance(v, float) else v) for k, v in summary.items() if k != 'predict_miou1_epoch_classes'} }")
    # per crop: K1 for both chain heads and the key resample, K2 for both chains
    expected = {"grid_sample_cuda": 3 * crops * windows, "grid_sample_backward_cuda": 0,
                "warp_chain_cuda": 2 * crops * windows, "resize_quantize_int8_cuda": 0}
    log(f"  launches over {windows} windows: {counts} (expected {expected})")
    if windows != 2 or counts != expected:
        raise AssertionError(f"the crop route launched {counts} over {windows} windows")
    pngs = sorted(os.listdir(os.path.join(out_dir, "frames")))
    frames = read_mjpg_avi(video)
    log(f"  {len(pngs)} PNGs; the AVI ({os.path.getsize(video) / 1e6:.1f} MB) reads back "
        f"as {len(frames)} frames of {frames[0].shape if frames else None}")
    if len(pngs) != 2 * n or len(frames) != 2 * n or frames[0].shape != FRAME_HW + (3,):
        raise AssertionError(f"the crop route's PNGs or AVI are not {2 * n} frames")
    m = imread(os.path.join(out_dir, "frames", "0.png"))
    if m.shape != FRAME_HW or int(m.max()) >= CLASSES:
        raise AssertionError(f"PNG map {m.shape} with classes up to {int(m.max())}")
    per = {k: prof.mean(k) for k in ("predict_interference", "crop_forward",
                                      "crop_probs_to_host", "crop_canvas")}
    log(f"  seconds a window: {per['predict_interference']:.3f} (crops through the "
        f"device {per['crop_forward']:.3f}, probabilities to the host "
        f"{per['crop_probs_to_host']:.3f}, float64 canvas {per['crop_canvas']:.3f}); "
        f"whole run with PNGs and AVI {total:.1f} s")
    log(f"  device: busy {dt['busy_ms']:.1f} ms a window, {dt['kernels']:.0f} kernels, "
        f"device-to-host copies {dt['d2h_ms']:.1f} ms (torch.profiler); peak memory "
        f"{peak_gb:.2f} GB")
    return {"summary": summary, "launches": counts, "windows": windows, "peak_gb": peak_gb,
            "seconds": per, "total_s": total, **dt}


def crop_card_vs_cpu(n=5, frame_hw=(128, 192), crop=64, seed=1) -> None:
    """Phase 12b: the crop route in float32 on the card against the CPU at
    a small size (128x192 frames, 64 px crops, n = 5): probabilities within
    1e-4, maps equal away from near-ties (twice that)."""
    root = os.path.join(DATA_DIR, "tree_small")
    shutil.rmtree(root, ignore_errors=True)
    generate_synthetic_dataset(root, num_frames=n + 1, size=frame_hw, frame_delta=n,
                               num_labeled=1)
    ds = FlowDataset("predict", root, type="u", frame_delta=n, predict_v_id="synth",
                     transform=build_test_transform(resize=frame_hw, normalize=False))
    batch = collate([ds.get(0, np.random.default_rng(0))])
    cpu_model = random_model("pspnet", torch.float32, seed)
    gpu_model = copy.deepcopy(cpu_model)
    res = {}
    for dev, m in ((torch.device("cpu"), cpu_model), (torch.device("cuda"), gpu_model)):
        fn = make_flow_predict_crop_fn(m, n, CLASSES, default_grid=ds.default_grid, device=dev)
        seen = {}

        def recording(*args):
            seen["probs"] = fn(*args)
            return seen["probs"]

        maps = flow_sliding_window_predict(recording, m.state_dict(), batch, CLASSES, crop,
                                           crop, frame_hw)
        res[dev.type] = (seen["probs"].cpu().numpy(), maps.cpu().numpy())
    (pc, mc), (pg, mg) = res["cpu"], res["cuda"]
    err = float(np.abs(pg - pc).max())
    log(f"  probabilities {pc.shape}: max_abs_err {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"crop probabilities differ between card and CPU: {err}")
    offs = crop_offsets(*frame_hw, crop, crop)
    canvas = np.zeros((n,) + frame_hw + (CLASSES,))
    count = np.zeros(frame_hw + (1,))
    for (h, w), p in zip(offs, pc):
        canvas[:, h:h + crop, w:w + crop] += p
        count[h:h + crop, w:w + crop] += 1
    top2 = np.sort(canvas / count, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2e-4
    same = mg == mc
    log(f"  maps {mc.shape}: {same.mean():.6f} equal, {int((~same & clear).sum())} differ "
        f"away from near-ties ({clear.mean():.4f} of pixels clear)")
    if (~same & clear).any():
        raise AssertionError("card and CPU crop-route maps differ away from near-ties")


# ------------------------------------------- training: 3t, 4t and 14-17

# phase 4t's hold on what a step changed: per tensor, the card's change
# against the CPU's within STEP_FLOOR_FACTOR times the CPU float32 change's
# own distance to the float64 change (its noise floor), and never held
# tighter than STEP_ABS; both relative to the tensor's largest change. The
# card's float32 change sat up to 11.2 times farther from the float64 one
# than the CPU's (layer4.2.conv1.weight, an H100 80GB HBM3): rounding that
# BN's backward amplifies differs by tensor, so the factor is about three
# times that
STEP_FLOOR_FACTOR = 32.0
STEP_ABS = 1e-3
# each architecture's warps in a training step of the repository's flow
# config (batch 2, the 433 px crop through round_train): the encoding's
# channels and size, the crop's block grid, the crop
TRAIN_SHAPES = {"pspnet": (4096, (55, 55), (27, 27), 433),
                "deeplabv3": (2048, (55, 55), (27, 27), 433),
                "vit": (768, (13, 13), (26, 26), 416)}
# a training step's device time by family of kernel names (the first family
# whose pattern a name contains takes it; cuBLAS's "xmma_gemm" products before
# cuDNN's "xmma_fprop_implicit_gemm" convolutions)
TRAIN_FAMILIES = (
    ("K1", ("grid_sample_kernel",)),
    ("K1-bwd", ("grid_sample_backward_",)),
    ("conv backward", ("dgrad", "wgrad", "bprop", "backward_data", "backward_filter")),
    ("conv forward", ("fprop", "conv", "cudnn", "implicit")),
    ("matrix products", ("gemm", "nvjet", "cutlass")),
    ("OHEM sort", ("sort", "Sort", "radix", "Radix")),
    ("optimizer", ("multi_tensor_apply",)),
    ("softmax", ("softmax", "Softmax")),
    ("reductions (BN and LayerNorm statistics)", ("reduce_kernel",)),
    ("copies and casts", ("copy", "CatArray")),
    ("other elementwise (BN, ReLU, dropout, blend, losses)", ("",)),
)


def train_crop_grids(seed=0, n=FRAME_DELTA, frame_hw=FRAME_HW, crop=CROP) -> torch.Tensor:
    """The training batch's own grids: two samples' left chains of a
    synthetic 1072x1920 clip through the flow train transform (random
    scale, flip and the ``crop`` px crop, as FlowDataset items take it),
    (n-1, 2, crop // 16, crop // 16, 2) float32 on the CPU."""
    clip = synthetic_clip(2 * n + 1, size=frame_hw, frame_ids=(), seed=seed)
    tf = build_train_transform(crop, crop, resize=frame_hw, with_rotate=False,
                               crop_padding=None, normalize=False)
    chains = []
    for b in range(2):
        sample = {"label": np.zeros(frame_hw, np.uint8),
                  "mvs_left": list(clip["grids"][1 + b * n:(b + 1) * n])}
        chains.append(np.stack(tf(sample, np.random.default_rng((seed, b)))["mvs_left"]))
    return torch.as_tensor(np.stack(chains, axis=1)).contiguous()


def train_grids(dev, seed=0, crop=CROP) -> dict:
    """Phase 3t's grids (2, gh, gw, 2) for a ``crop`` px crop: random in
    [-1.1, 1.1], the training batch's first and second crop grids (a chain's
    head and a chain step), the identity (block centres of the crop,
    align_corners=False) and one that clamps every point to the top-left
    corner (all of a point's taps, and so all atomics, on one source
    pixel)."""
    g = torch.Generator().manual_seed(seed)
    chain = train_crop_grids(seed, crop=crop)
    hw = (crop // 16, crop // 16)
    ident = torch.as_tensor(default_grid(hw[0] * 16, hw[1] * 16))[None].expand(2, -1, -1, -1)
    grids = {"random": torch.rand((2,) + hw + (2,), generator=g) * 2.2 - 1.1,
             "train-crop": chain[0], "train-crop step": chain[1], "identity": ident,
             "corner": torch.full((2,) + hw + (2,), -1.5)}
    return {k: v.to(dev).contiguous() for k, v in grids.items()}


def check_k1_bwd(name, go, grid, x_shape) -> float:
    """K1-bwd bit-equal, by integer view, to its plain version computed on
    the CPU from the same inputs (the CPU's index_add_ adds in the order the
    kernel keeps; on the card it is atomic), and two launches on one input
    bit-equal. Returns the max abs error, 0."""
    got = grid_sample_backward_cuda(go, grid, x_shape, False)
    again = grid_sample_backward_cuda(go, grid, x_shape, False)
    ref = grid_sample_backward(go.cpu(), grid.cpu(), x_shape, False)
    got, again = got.cpu(), again.cpu()
    differ, rerun = bits_differ(got, ref), bits_differ(again, got)
    err = float((got.float() - ref.float()).abs().max())
    ok = differ == 0 and rerun == 0
    log(f"  {name}: {differ} elements differ from the CPU's plain version, {rerun} between "
        f"two runs, max_abs_err {err:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} is not bit-equal to its plain version on the CPU "
                             f"({differ} elements) or to itself ({rerun})")
    return err


def kernel_split_us(fn, flush, pattern, reps=10) -> dict:
    """Device us a call of fn() by kernel, for the kernels whose names
    contain ``pattern`` (torch.profiler over ``reps`` calls, the L2 flushed
    before each): where a launch sequence spends its time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if pattern in e.key:
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.key).split("(")[0]
            split[name] = split.get(name, 0.0) + e.device_time_total / reps
    return split


def time_k1_bwd(g_out, grid, x_shape, flush, cpm) -> dict:
    """K1-bwd's time beside its bound (grad_out and the grid read once,
    grad_x written once; 4 multiplies and 4 adds per element of grad_out),
    its plain version's and the library's: aten.grid_sampler_2d_backward on
    NCHW, the input's gradient only."""
    out = grid_sample_backward_cuda(g_out, grid, x_shape, False)
    b = bound(nbytes(g_out, grid, out), 8 * g_out.numel())
    gn = g_out.permute(0, 3, 1, 2).contiguous()
    xn = torch.zeros((x_shape[0], x_shape[3], x_shape[1], x_shape[2]), dtype=g_out.dtype,
                     device=g_out.device)
    grid_l = grid.to(g_out.dtype)
    return {
        "ms": time_ms(lambda: grid_sample_backward_cuda(g_out, grid, x_shape, False), flush, cpm),
        "plain_ms": time_ms(lambda: grid_sample_backward(g_out, grid, x_shape, False), flush,
                            cpm, reps=5),
        "library_ms": time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gn, xn, grid_l, 0, 1, False, [True, False]), flush, cpm),
        "bound_ms": b[0], "bound_by": b[1],
        "split_us": kernel_split_us(lambda: grid_sample_backward_cuda(g_out, grid, x_shape,
                                                                      False),
                                    flush, "grid_sample_backward_"),
    }


def check_train_kernels(dev, arch="pspnet", dtypes=(torch.float32, torch.bfloat16)) -> tuple:
    """Phase 3t for one architecture's training shapes (TRAIN_SHAPES): K1
    and K1-bwd at (2, head, C) -> grid (a chain's head; for the ViT an
    up-sample of the token map) and (2, grid, C) -> grid (its steps), in
    ``dtypes``, on phase 3t's grids for its crop: K1 bit-equal to its plain
    version, K1-bwd bit-equal to its plain version on the CPU
    and to itself from run to run (check_k1_bwd). Then both timed in
    float32 (the training dtype) on the training batch's grids, and K1-bwd
    in bf16 where bf16 is checked. Timing keys carry the architecture but
    PSPNet's."""
    c, head_hw, grid_hw, crop = TRAIN_SHAPES[arch]
    grids = train_grids(dev, crop=crop)
    g = torch.Generator().manual_seed(1)
    xs = {hw: torch.randn((2,) + hw + (c,), generator=g) for hw in (head_hw, grid_hw)}
    g_out = torch.randn((2,) + grid_hw + (c,), generator=g)
    errs = {}
    for dtype in dtypes:
        tag = str(dtype).replace("torch.", "")
        go = g_out.to(dev, dtype)
        for hw, x0 in xs.items():
            x = x0.to(dev, dtype)
            for what, grid in grids.items():
                note_err(errs, "grid_sample_cuda", dtype, check_k1(
                    f"K1 {tag} x{tuple(x.shape)} {what}", x, grid, False))
                note_err(errs, "grid_sample_backward_cuda", dtype, check_k1_bwd(
                    f"K1-bwd {tag} grad_x{tuple(x.shape)} {what}", go, grid, tuple(x.shape)))
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    res = {}
    go = g_out.to(dev)
    label = "" if arch == "pspnet" else f"{arch} "
    for hw, part, grid in ((head_hw, "head", grids["train-crop"]),
                           (grid_hw, "step", grids["train-crop step"])):
        x = xs[hw].to(dev)
        shape = tuple(x.shape)
        res[f"grid_sample_cuda ({label}train {part}, float32)"] = time_k1(
            x, x.permute(0, 3, 1, 2).contiguous(), grid, grid, False, flush, cpm)
        res[f"grid_sample_backward_cuda ({label}train {part}, float32)"] = time_k1_bwd(
            go, grid, shape, flush, cpm)
    if torch.bfloat16 in dtypes:
        res[f"grid_sample_backward_cuda ({label}train head, bf16)"] = time_k1_bwd(
            go.to(torch.bfloat16), grids["train-crop"], (2,) + head_hw + (c,), flush, cpm)
    log_timing(res, "library")
    return errs, res


# the reference's full-frame block grid, whose K1-bwd index build does not fit
# one block's shared memory
WIDE_GRID = (67, 120)


def check_k1_bwd_workspace(dev, c=256, seed=2) -> tuple:
    """Phase 3t's K1-bwd where its index build keeps its working arrays in
    a device workspace: a (1, 67, 120) grid onto (1, 134, 240, c), on
    random grids, the block centres (the identity, align_corners=False) and
    the corner grid (all 32160 entries on one pixel), float32 and bf16, each
    bit-equal to its plain version on the CPU and from run to run; then
    timed in float32 on the random grid. Returns (errors, timing)."""
    gh, gw = WIDE_GRID
    x_shape = (1, 2 * gh, 2 * gw, c)
    if not warp_library().floodseg_grid_sample_backward_workspace(1, x_shape[1], x_shape[2],
                                                                  gh, gw):
        raise AssertionError(f"K1-bwd at {x_shape} would build its index in shared memory")
    g = torch.Generator().manual_seed(seed)
    go = torch.randn((1, gh, gw, c), generator=g)
    grids = {"random": torch.rand((1, gh, gw, 2), generator=g) * 2.2 - 1.1,
             "identity": torch.as_tensor(default_grid(gh * 16, gw * 16))[None],
             "corner": torch.full((1, gh, gw, 2), -1.5)}
    grids = {k: v.to(dev).contiguous() for k, v in grids.items()}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for what, grid in grids.items():
            note_err(errs, "grid_sample_backward_cuda", dtype, check_k1_bwd(
                f"K1-bwd {tag} grad_x{x_shape} {what} (workspace route)", go.to(dev, dtype),
                grid, x_shape))
    res = {"grid_sample_backward_cuda (workspace route, float32)": time_k1_bwd(
        go.to(dev), grids["random"], x_shape, L2Flush(dev), sleep_cycles_per_ms())}
    log_timing(res, "library")
    return errs, res


def check_k1_bwd_unaligned(dev, seed=4) -> tuple:
    """Phase 3t's K1-bwd on grad_out that is a contiguous view at an odd
    element offset, C = 5 (the one-element route, as the backward of a
    stack or an unbind may hand it over): the PSPNet head shape's grids and
    the workspace route's, float32 and bf16, bit-equal to the plain version
    on the CPU and from run to run. Returns (errors, {})."""
    g = torch.Generator().manual_seed(seed)
    errs = {}
    for grid_hw, x_hw in (((27, 27), (55, 55)), (WIDE_GRID, (134, 240))):
        b = 2 if grid_hw != WIDE_GRID else 1
        x_shape = (b,) + x_hw + (5,)
        grid = (torch.rand((b,) + grid_hw + (2,), generator=g) * 2.2 - 1.1).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.randn(1 + b * grid_hw[0] * grid_hw[1] * 5, generator=g)
            go = flat.to(dev, dtype)[1:].view((b,) + grid_hw + (5,))
            assert go.is_contiguous() and go.data_ptr() % 16 != 0
            tag = str(dtype).replace("torch.", "")
            note_err(errs, "grid_sample_backward_cuda", dtype, check_k1_bwd(
                f"K1-bwd {tag} grad_x{x_shape} random, grad_out at an odd offset", go, grid,
                x_shape))
    return errs, {}


def train_batch(seed=3, size=65, n=5, device="cpu") -> dict:
    """A flow training batch of two samples: normalised-range frames
    (size px), chains of n - 1 grids (size // 16 blocks, float32, the
    second sample's left chain 3 long), labels with 5% ignored."""
    rng = np.random.default_rng(seed)
    gh = size // 16
    base = np.stack(np.meshgrid(np.linspace(-0.9, 0.9, gh), np.linspace(-0.9, 0.9, gh)), -1)

    def chain():
        return torch.as_tensor((base[None, None] + rng.uniform(
            -0.1, 0.1, (n - 1, 2, gh, gh, 2))).astype(np.float32), device=device).contiguous()

    labels = rng.integers(0, CLASSES, (2, size, size))
    labels = np.where(rng.random(labels.shape) < 0.05, 255, labels).astype(np.int32)
    frames = {k: torch.as_tensor(rng.standard_normal((2, size, size, 3)).astype(np.float32),
                                 device=device)
              for k in ("frame_prev", "frame_next", "frame_current")}
    return {**frames, "mvs_left": chain(), "mvs_right": chain(),
            "left_index": np.array([1, 3], np.int32),
            "right_index": np.array([n - 1, n - 3], np.int32),
            "label": torch.as_tensor(labels, device=device)}


def fixed_keep_masks(model, store: dict, seed=5) -> list:
    """Every Dropout of ``model`` takes one keep mask per module name and
    input shape, drawn on the CPU (from ``seed`` and the name) at its first
    call and kept in ``store``: runs on the card and on the CPU that share
    ``store`` drop the same elements. Returns the hooks' handles."""
    handles = []
    for name, mod in model.named_modules():
        if not isinstance(mod, Dropout):
            continue

        def hook(mod, args, name=name):
            x = args[0]
            key = (name, tuple(x.shape))
            if key not in store:
                g = torch.Generator().manual_seed(seed + zlib.crc32(name.encode()))
                shape = [1 if d in mod.broadcast_dims else s for d, s in enumerate(x.shape)]
                store[key] = torch.rand(shape, generator=g) < 1.0 - mod.rate
            mod.keep = store[key].to(x.device)
        handles.append(mod.register_forward_pre_hook(hook))
    return handles


def train_steps(model, batch, masks, dev, dtype=torch.float32,
                steps=("interp", "plain", "eval")) -> dict:
    """``steps`` of ``model`` on ``dev`` in ``dtype``, each from ``model``'s
    own state (the flow config's SGD: lr 1e-4, the heads at 10x; OHEM with
    its min_kept, which skips mining at this size): interpolated, plain,
    "supervised" (single frame, the aux loss at 0.4) and "eval" (the flow
    eval step); every dropout takes the masks of ``masks`` (a store shared
    with the other runs, fixed_keep_masks). Returns each train step's loss
    and the state_dict after it (float64 on the CPU), and the eval counts."""
    batch = {k: (v.to(dev, dtype) if torch.is_tensor(v) and k.startswith("frame")
                 else v.to(dev) if torch.is_tensor(v) else v) for k, v in batch.items()}

    def fresh():
        m = copy.deepcopy(model).to(dev, dtype)
        for mod in m.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = dtype
        if dev.type == "cuda":
            m.to(memory_format=torch.channels_last)
        fixed_keep_masks(m, masks)
        return m

    out = {}
    for name in steps:
        m = fresh()
        if name == "eval":
            ev = make_flow_eval_step(m, CLASSES, 255)(None, batch)
            out["eval"] = {k: v.cpu() for k, v in ev.items()}
            continue
        opt, sched = make_optimizer(m, default_fit_config().lr, 10)
        if name == "supervised":
            step = make_train_step(m, make_loss_fn("ohem", 0.4, 255, 0.7, 100000), CLASSES, 255)
        else:
            interp, plain = make_flow_train_step(m, make_loss_fn("ohem", 0.0, 255, 0.7, 100000),
                                                 CLASSES, 255)
            step = interp if name == "interp" else plain
        _, metrics = step(TrainState(0, m, opt, sched), batch, None)
        out[name] = (float(metrics["loss"]), {k: v.detach().double().cpu().clone()
                                              for k, v in m.state_dict().items()})
    return out


def step_rel(a: dict, b: dict, p0: dict) -> dict:
    """Per tensor that ``b``'s step moved: max|a - b| / max|b - p0|, how far
    ``a``'s change (a - p0) is from ``b``'s relative to the largest
    change."""
    out = {}
    for k, ref in b.items():
        scale = float((ref - p0[k]).abs().max()) if ref.numel() else 0.0
        if scale > 0.0:
            out[k] = float((a[k] - ref).abs().max()) / scale
    return out


# phase 4t's models: (name, arch, frame size, train steps)
STEP_CHECKS = (("PSPNet-50", "pspnet", 65, ("interp", "plain", "supervised", "eval")),
               ("DeepLabV3-50", "deeplabv3", 65, ("interp", "plain", "eval")),
               ("ViT-B/32", "vit", 128, ("interp", "plain", "eval")))


def check_train_step_card_vs_cpu(arch="pspnet", size=65, n=5,
                                 steps=("interp", "plain", "eval")) -> None:
    """Phase 4t for one model: its ``steps`` (PSPNet-50 and DeepLabV3-50
    with their aux heads at 65 px; ViT-B/32 at 128 px, 4x4 tokens on 8x8
    grids, so each chain's head up-samples), batch 2, frame_delta 5,
    float32 with TF32 off (the steps run under full_precision_f32), on the
    card against the CPU, each step from the same initial state with the
    same dropout keep masks (the config's SGD, lr 1e-4): losses within rtol
    1e-4; every parameter and BN statistic within 1e-4 of its tensor's
    largest magnitude; the same tensors moved; and what the step changed
    (p1 - p0, the gradient through the warps' K1-bwd, the momentum and the
    weight decay, or the BN statistics' update) within the tensor's float32
    noise floor (STEP_FLOOR_FACTOR, STEP_ABS) of the CPU's change; eval
    counts within 1% of the pixels. The same steps in float64 on the CPU
    give that floor."""
    model = random_model(arch, torch.float32, seed=4, image_size=size, with_aux=True)
    p0 = {k: v.detach().double().clone() for k, v in model.state_dict().items()}
    masks = {}
    t0 = time.perf_counter()
    card = train_steps(model, train_batch(size=size, n=n), masks, torch.device("cuda"),
                       steps=steps)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = train_steps(model, train_batch(size=size, n=n), masks, torch.device("cpu"),
                      steps=steps)
    f64 = train_steps(model, train_batch(size=size, n=n), masks, torch.device("cpu"),
                      torch.float64, steps=steps)
    kept = torch.cat([m.reshape(-1).float() for m in masks.values()])
    log(f"  card {t_card:.1f} s, CPU {time.perf_counter() - t0:.1f} s (float32 and float64) "
        f"for the {len(steps)} steps; {len(masks)} dropout masks, keeping "
        f"{float(kept.mean()):.3f} of {kept.numel()} elements")

    def rel_diffs(a, b):
        out = {}
        for k, ref in b.items():
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            if scale > 0.0:
                out[k] = float((a[k] - ref).abs().max()) / scale
        return out

    for name in (s for s in steps if s != "eval"):
        (lc, sc), (lh, sh), (l64, s64) = card[name], cpu[name], f64[name]
        d = rel_diffs(sc, sh)
        key = max(d, key=d.get)
        ok = abs(lc - lh) <= 1e-4 * abs(lh) and d[key] <= 1e-4
        log(f"  {name} step: loss card {lc:.7f} CPU {lh:.7f} float64 {l64:.7f} (card vs "
            f"CPU rel {abs(lc - lh) / abs(lh):.2e}, tol 1e-4); largest parameter or BN "
            f"statistic difference {d[key]:.2e} of its tensor's largest magnitude ({key}; "
            f"tol 1e-4) -> {'ok' if ok else 'FAIL'}")
        # what the step changed: card vs CPU, against the CPU float32 floor
        moved = {k for k in sh if not torch.equal(sh[k], p0[k])}
        moved_card = {k for k in sc if not torch.equal(sc[k], p0[k])}
        e, floor = step_rel(sc, sh, p0), step_rel(sh, s64, p0)
        card_floor = step_rel(sc, s64, p0)
        limit = {k: max(STEP_ABS, STEP_FLOOR_FACTOR * floor.get(k, 0.0)) for k in e}
        worst = sorted(e, key=lambda k: e[k] / limit[k], reverse=True)[:5]
        step_ok = moved == moved_card and all(e[k] <= limit[k] for k in e)
        log(f"    the step's change, {len(e)} tensors moved ({len(moved_card)} on the card): "
            f"card vs CPU median {statistics.median(e.values()):.2e} of the tensor's largest "
            f"change; the float32 floor (CPU vs float64) median "
            f"{statistics.median(floor.values()):.2e}, card vs float64 median "
            f"{statistics.median(card_floor.values()):.2e}; card over CPU distance to float64 "
            f"at most {max(card_floor[k] / max(floor[k], 1e-30) for k in floor):.2f}x -> "
            f"{'ok' if step_ok else 'FAIL'}")
        log("    closest to the limit, card vs CPU | limit | CPU vs float64 | card vs float64: "
            + "; ".join(f"{k} {e[k]:.2e} | {limit[k]:.2e} | {floor.get(k, 0.0):.2e} | "
                        f"{card_floor.get(k, 0.0):.2e}" for k in worst))
        if not (ok and step_ok):
            raise AssertionError(f"the {arch} {name} train step on the card disagrees with "
                                 f"the CPU")
    pixels = float(cpu["eval"]["target"].sum())
    diff = {k: float((card["eval"][k] - cpu["eval"][k]).abs().sum()) for k in cpu["eval"]}
    log(f"  eval counts card vs CPU: summed differences {diff} of {pixels:.0f} pixels")
    if diff["target"] != 0 or max(diff.values()) > 0.01 * pixels:
        raise AssertionError(f"eval counts card vs CPU differ: {diff}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_tree(n=FRAME_DELTA, frame_hw=FRAME_HW, frames=100, labeled=40) -> str:
    """The training phases' tree: ``frames`` frames of 1072x1920 from the
    port's writer under build/data/train_tree, ``labeled`` of them with
    labels (28 train items, 6 val)."""
    root = os.path.join(DATA_DIR, "train_tree")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    generate_synthetic_dataset(root, num_frames=frames, size=frame_hw, frame_delta=n,
                               num_labeled=labeled)
    log(f"  tree: {frames} frames of {frame_hw[0]}x{frame_hw[1]} written in "
        f"{time.perf_counter() - t0:.1f} s")
    return root


# phases 14-17 and 19-20: (phase, tag, arch, trunk depth, method, crop, steps,
# warm-up, validation frames); the crop goes through round_train
TRAIN_PHASES = (
    ("14", "pspnet_f32_train", "pspnet", 50, "flow_supervised", CROP, 14, 2, 3),
    ("15", "deeplabv3_f32_train", "deeplabv3", 101, "flow_supervised", CROP, 8, 2, 2),
    ("16", "vit_f32_train", "vit", 0, "flow_supervised", CROP, 8, 2, 2),
    ("17", "pspnet_f32_supervised", "pspnet", 50, "supervised", 873, 8, 2, 2),
)
GAN_PHASES = (
    ("19", "pspnet_f32_flow_gan", "pspnet", 50, "flow_gan", CROP, 10, 2, 2),
    ("20", "pspnet_f32_gan", "pspnet", 50, "gan", 873, 6, 2, 2),
)
# the s4GAN configs' generator optimizers (configs/train_flow_gan.yaml,
# configs/train_gan.yaml); the discriminator's Adam at lr_D 1e-4 in both
GAN_OPTIM = {"flow_gan": {"lr": 1e-4, "weight_decay": 1e-4},
             "gan": {"lr": 2.5e-4, "weight_decay": 5e-4}}
GAN_LOSSES = ("loss_s", "loss_d", "loss_fm")
D_CONV_FAMILY = "discriminator convolutions (4x4, forward and backward)"


def d_conv_launches(events) -> set:
    """The correlation ids of the kernels that the s4GAN discriminator's
    convolutions (forward and backward) launched, from a chrome trace
    recorded with shapes: launches (runtime calls) inside a convolution op
    on the same thread that has an operand of shape (., ., 4, 4), a kernel
    size no generator has."""
    spans = {}
    for e in events:
        dims = e.get("args", {}).get("Input Dims") or []
        if e.get("cat") == "cpu_op" and "conv" in e.get("name", "") and any(
                isinstance(d, list) and len(d) == 4 and d[2:] == [4, 4] for d in dims):
            spans.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e["dur"]))
    return {e["args"]["correlation"] for e in events
            if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})
            and any(t0 <= e["ts"] <= t1 for t0, t1 in spans.get(e.get("tid"), ()))}


def train_phase(dev, root, tag, arch="pspnet", layers=50, method="flow_supervised",
                crop=CROP, steps=14, warmup=2, val_batches=3, profiled=2,
                n=FRAME_DELTA, frame_hw=FRAME_HW) -> dict:
    """Phases 14-17 and 19-20: training at full width through run_flow_fit
    (``flow_supervised``), run_fit (``supervised``) or run_gan_fit
    (``flow_gan``, ``gan``) on the tree at ``root``: the repository's
    configuration for the method (float32, batch 2, the crop through
    round_train, n = 25, SGD with the heads at 10x, OHEM 0.7 / 100000; the
    single-frame methods' rotating transform with MEAN padding and the aux
    loss at 0.4; s4GAN: the configs' SGD without the aux head and the
    discriminator's Adam, a random discriminator), ``steps`` steps
    (``warmup`` untimed, the last ``profiled`` under torch.profiler) and a
    validation pass over ``val_batches`` frames. The loader alone first.
    Checks: a finite loss; K1 48 and K1-bwd 48 launches every
    flow_supervised step and 96 each every flow_gan step (two generator
    forwards), K1 48 a validation frame, K2 and K3 none, and no launch at
    all in the single-frame methods; every BN's running mean moved but, in
    flow training (which never runs it), the aux head's; after the first
    flow_supervised step each aux parameter equals p0 - 10 lr wd p0; in
    s4GAN every aux parameter equal to its start to the bit after every
    step, every step's loss_s, loss_d and loss_fm finite, and every
    discriminator parameter moved. (Smaller arguments rehearse it on the
    CPU.)"""
    from torch.profiler import ProfilerActivity, profile as tprofile
    flow = method in ("flow_supervised", "flow_gan")
    gan = method in ("flow_gan", "gan")
    model = random_model(arch, torch.float32, seed=7, image_size=round_train(crop, arch),
                         with_aux=True, layers=layers)
    cfg = default_fit_config(train_h=crop, train_w=crop, resize_h=frame_hw[0], resize_w=frame_hw[1],
                             frame_delta=n, max_epochs=1, limit_train_batches=steps,
                             limit_val_batches=val_batches, **GAN_OPTIM.get(method, {}))
    disc = None
    if gan:
        disc = init_from_generator_(S4GANDiscriminator(CLASSES),
                                    torch.Generator().manual_seed(8))
        d0 = {k: v.detach().clone() for k, v in disc.state_dict().items()}
    size = round_train(crop, arch)
    log(f"  {arch} ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters), "
        f"{method}, {size} px crops; TF32 off (the steps run under full_precision_f32); {cfg}")
    # the loader alone: host ms a batch (8 threads), before any training
    lst = os.path.join(root, "list", "all", "train.txt")
    if flow:
        ds = FlowDataset("train", root, lst, transform=flow_transforms(cfg, arch)["train"],
                         frame_delta=n)
    else:
        ds = SemDataset("train", root, lst, sem_transforms(cfg, arch)["train"])
    loader = DataLoader(ds, batch_size=cfg.batch_size, shuffle=True, num_workers=cfg.workers,
                        seed=cfg.seed, drop_last=True)
    t0, stamps = time.perf_counter(), []
    for b in loader:
        stamps.append(time.perf_counter())
    loader_ms = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    log(f"  the loader alone: {len(stamps)} batches of {tuple(b['frame_current'].shape)}, "
        f"first after {stamps[0] - t0:.2f} s, then {loader_ms:.1f} ms a batch (8 threads)")

    aux_prefix = {"pspnet": "aux.", "deeplabv3": "aux_classifier."}.get(arch)
    aux0 = {k: v.detach().clone() for k, v in model.named_parameters()
            if aux_prefix and k.startswith(aux_prefix)}
    bn0 = {k: v.clone() for k, v in model.state_dict().items() if k.endswith("running_mean")}
    counts_by_step, prev = [], {}
    tp = tprofile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else []), record_shapes=gan)
    aux_err, aux_changed, gan_losses = [], [], []

    def on_step(step, state, metrics):
        now = launch_counts()
        counts_by_step.append({k: v - prev.get(k, 0) for k, v in now.items()})
        prev.update(now)
        if gan:
            params = dict(model.named_parameters())
            aux_changed.extend((step, k) for k, p0 in aux0.items()
                               if not torch.equal(params[k].detach().cpu(), p0))
            gan_losses.append({k: metrics[k] for k in GAN_LOSSES})
        elif step == 0 and flow:
            lr = state.schedule(0) * 10
            for k, p0 in aux0.items():
                p1 = dict(model.named_parameters())[k].detach().cpu()
                want = p0 - lr * (1e-4 * p0)
                aux_err.append(float((p1 - want).abs().max() / want.abs().max().clamp_min(1e-30)))
        if step == steps - profiled - 1:
            _sync(dev)
            tp.start()
        if step == steps - 1:
            _sync(dev)
            tp.stop()

    prof = PhaseProfiler(sync=lambda: _sync(dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    if gan:
        summary = run_gan_fit(model, root, cfg, method, discriminator=disc, profiler=prof,
                              on_step=on_step, device=dev)
    else:
        run = run_flow_fit if flow else run_fit
        summary = run(model, root, cfg, profiler=prof, on_step=on_step, device=dev)
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    step_s = prof.recorded_durations["train_step"]
    load_s = prof.recorded_durations["train_load"]
    timed = slice(warmup, steps - profiled)
    step_ms = 1e3 * statistics.median(step_s[timed])
    wait_ms = 1e3 * statistics.median(load_s[timed])
    epoch = summary["epochs"][0]
    log(f"  {summary['steps']} steps in {total:.1f} s with validation; ms a step (median of "
        f"{len(step_s[timed])}, synchronised): {step_ms:.1f} -> "
        f"{1e3 * cfg.batch_size / step_ms:.2f} samples/s; the step's wait for its batch "
        f"{wait_ms:.1f} ms (median); every step's ms {[round(1e3 * s, 1) for s in step_s]}")
    log(f"  train loss {epoch['train_loss']:.5f}, val mIoU {epoch['val_miou']:.4f} over "
        f"{val_batches} frames; peak memory {peak_gb:.2f} GB")
    if not np.isfinite(epoch["train_loss"]):
        raise AssertionError(f"the training loss is not finite: {epoch['train_loss']}")
    warps = 2 * (n - 1) if dev.type == "cuda" and flow else 0  # two chains of n - 1 warps
    forwards = 2 if gan else 1  # s4GAN: the labeled and the unlabeled batch
    per_step = {"grid_sample_cuda": forwards * warps,
                "grid_sample_backward_cuda": forwards * warps,
                "warp_chain_cuda": 0, "resize_quantize_int8_cuda": 0}
    bad = [(i, c) for i, c in enumerate(counts_by_step) if c != per_step]
    expected = {"grid_sample_cuda": warps * (forwards * steps + val_batches),
                "grid_sample_backward_cuda": forwards * warps * steps, "warp_chain_cuda": 0,
                "resize_quantize_int8_cuda": 0}
    log(f"  launches: {counts} (expected {expected}); every step {per_step}: "
        f"{'yes' if not bad else bad}")
    if bad or counts != expected:
        raise AssertionError(f"the training path launched {counts}, steps {bad}")
    if gan:
        host = [{k: float(v) for k, v in m.items()} for m in gan_losses]
        moved_d = [k for k, v in disc.state_dict().items() if not torch.equal(v.cpu(), d0[k])]
        log(f"  s4GAN: every step's {', '.join(GAN_LOSSES)} "
            f"{[[round(m[k], 5) for k in GAN_LOSSES] for m in host]}; discriminator "
            f"parameters moved {len(moved_d)} of {len(d0)}; aux parameters changed after a "
            f"step: {aux_changed or 'none'} ({len(aux0)} checked after each of {len(host)} "
            f"steps)")
        if not all(np.isfinite(v) for m in host for v in m.values()) or len(host) != steps:
            raise AssertionError(f"an s4GAN loss is not finite: {host}")
        if aux_changed or not aux0 or len(moved_d) != len(d0):
            raise AssertionError(f"s4GAN: aux changed {aux_changed}, discriminator moved "
                                 f"{len(moved_d)} of {len(d0)}")
    elif flow and aux0:
        log(f"  aux head after the first step: largest |p1 - (p0 - 10 lr wd p0)| "
            f"{max(aux_err):.2e} of its tensor's largest magnitude (tol 1e-6)")
        if not aux_err or max(aux_err) > 1e-6:
            raise AssertionError(f"the aux head did not take the zero-gradient update: "
                                 f"{aux_err}")
    after = model.state_dict()
    moved = {k: not torch.equal(v, after[k].cpu()) for k, v in bn0.items()}
    in_aux = {k for k in moved if aux_prefix and k.startswith(aux_prefix)}
    stuck = [k for k, m in moved.items() if not m and not (flow and k in in_aux)]
    aux_moved = [k for k in in_aux if flow and moved[k]]
    log(f"  BN running means moved: {sum(moved.values())} of {len(moved)}"
        + (f" (the aux head's {len(in_aux)} are not run by flow training)" if flow and in_aux
           else "" if moved else " (the ViT has no BN)"))
    if stuck or aux_moved:
        raise AssertionError(f"BN statistics: not moved {stuck}, aux moved {aux_moved}")

    os.makedirs(PROFILE_DIR, exist_ok=True)
    trace = os.path.join(PROFILE_DIR, f"{tag}_trace.json")
    tp.export_chrome_trace(trace)
    with open(os.path.join(PROFILE_DIR, f"{tag}_profile.txt"), "w") as f:
        f.write(tp.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    d_launches = d_conv_launches(events) if gan else set()
    dt = device_time(trace, profiled)
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3 \
        if kernels else float("nan")
    # each family's kernels as the union of their spans: K1-bwd's gather is
    # resident, waiting, while its index build runs
    families_of = ((D_CONV_FAMILY, ()),) + TRAIN_FAMILIES if gan else TRAIN_FAMILIES
    spans = {name: [] for name, _ in families_of}
    for e in kernels:
        if e.get("args", {}).get("correlation") in d_launches:
            fam = D_CONV_FAMILY
        else:
            fam = next(name for name, pats in TRAIN_FAMILIES if any(p in e["name"] for p in pats))
        spans[fam].append((e["ts"], e["ts"] + e["dur"]))
    families = {name: union_us(v) / (1e3 * profiled) for name, v in spans.items()}
    log(f"  profiler over {profiled} steps: device busy {dt['busy_ms']:.1f} ms a step of "
        f"{span / profiled:.1f} (idle share {1 - dt['busy_ms'] * profiled / span:.1%}); "
        f"{dt['kernels']:.0f} kernels a step; ms a step by family "
        f"{ {k: round(v, 3) for k, v in families.items()} }")
    log(tp.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    return {"launches": counts, "step_ms": step_ms, "wait_ms": wait_ms, "loader_ms": loader_ms,
            "peak_gb": peak_gb, "busy_ms": dt["busy_ms"], "span_ms": span / profiled,
            "family_ms": families, "train_loss": epoch["train_loss"]}


def training_phases(dev) -> tuple:
    """Phases 3t, 4t and 14-17 in order; returns (3t's errors, 3t's timing,
    each phase's result by tag)."""
    log("[3t] K1 and K1-bwd at the training shapes (batch 2, 433 px crops, C = 4096; "
        "DeepLabV3 C = 2048; the ViT's 416 px crops, C = 768)")
    errs, timing = {}, {}
    checked = [check_train_kernels(dev, arch) for arch in TRAIN_SHAPES]
    checked += [check_k1_bwd_workspace(dev), check_k1_bwd_unaligned(dev)]
    for e, t in checked:
        timing.update(t)
        for kname, by in e.items():
            for tag, v in by.items():
                errs.setdefault(kname, {})[tag] = max(errs.get(kname, {}).get(tag, 0.0), v)
    for name, arch, size, steps in STEP_CHECKS:
        log(f"[4t] train steps on the card against the CPU ({name}, {size} px, float32: "
            f"{', '.join(steps)})")
        check_train_step_card_vs_cpu(arch, size=size, steps=steps)
    log("[14-17] training at full width")
    root = train_tree()
    results = {}
    names = {"pspnet": "PSPNet-50", "deeplabv3": "DeepLabV3-101", "vit": "ViT-B/32"}
    for phase, tag, arch, layers, method, crop, steps, warmup, val in TRAIN_PHASES:
        t0 = time.perf_counter()
        log(f"[{phase}] {method} through {'run_flow_fit' if method != 'supervised' else 'run_fit'}"
            f": {names[arch]} float32, batch 2, {round_train(crop, arch)} px crops of "
            f"{FRAME_HW[0]}x{FRAME_HW[1]} frames" + (f", n = {FRAME_DELTA}"
                                                      if method != "supervised" else ""))
        results[tag] = train_phase(dev, root, tag, arch, layers, method, crop, steps, warmup,
                                   val)
        log(f"  phase {phase}: {time.perf_counter() - t0:.1f} s")
    return errs, timing, results


# ------------------------------------------------- s4GAN: phases 4g, 19, 20

def gan_roles(size=65, n=5) -> dict:
    """Phase 4g's role batches on the CPU: a flow batch each for "l" (with
    labels) and "u" (without), and the gt role's frames and labels (the
    single-frame step reads only the frames and labels)."""
    u = train_batch(seed=6, size=size, n=n)
    gt = train_batch(seed=7, size=size, n=n)
    return {"l": train_batch(seed=3, size=size, n=n),
            "u": {k: v for k, v in u.items() if k != "label"},
            "gt": {k: gt[k] for k in ("frame_current", "label")}}


def _fresh(module, masks, dev, dtype):
    """A copy of ``module`` on ``dev`` in ``dtype`` (channels-last on the
    card) whose every Dropout takes the keep masks of ``masks``
    (fixed_keep_masks)."""
    m = copy.deepcopy(module).to(dev, dtype)
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = dtype
    if dev.type == "cuda":
        m.to(memory_format=torch.channels_last)
    fixed_keep_masks(m, masks)
    return m


def _on(batch: dict, dev, dtype) -> dict:
    return {k: (v.to(dev, dtype) if torch.is_tensor(v) and k.startswith("frame")
                else v.to(dev) if torch.is_tensor(v) else v) for k, v in batch.items()}


def _g_forward(g, method):
    return flow_g_forward(g) if method == "flow_gan" else single_frame_g_forward(g)


def gan_threshold(model, disc, roles, masks, method) -> tuple:
    """(threshold_st, its margin): halfway between the two unlabeled
    samples' sigmoid(D(pred_cat)) of the step's first discriminator call,
    on the CPU in float32 with the phase's masks, so that one sample of two
    passes."""
    dev = torch.device("cpu")
    g, d = _fresh(model, masks, dev, torch.float32), _fresh(disc, masks, dev, torch.float32)
    u = _on(roles["u"], dev, torch.float32)
    with torch.no_grad(), full_precision_f32():
        pred_u = _g_forward(g, method)(u, None)
        img = u["frame_current"]
        d.train()
        z, _ = d(torch.cat([torch.softmax(pred_u, -1),
                            (img - img.min()) / (img.max() - img.min())], -1))
    conf = sorted(float(c) for c in torch.sigmoid(z))
    return (conf[0] + conf[1]) / 2, (conf[1] - conf[0]) / 2


def gan_step(model, disc, roles, masks, dev, method, threshold, dtype=torch.float32) -> tuple:
    """One s4GAN step of copies of ``model`` and ``disc`` on ``dev`` in
    ``dtype`` from a state at step 1 (the gate's step > 0; fresh optimizer
    state): the config's generator SGD without the aux head, the
    discriminator's Adam (lr_D 1e-4, betas (0.9, 0.99)). Returns (the
    metrics, the generator's and the discriminator's state_dict after it),
    float64 on the CPU."""
    g, d = _fresh(model, masks, dev, dtype), _fresh(disc, masks, dev, dtype)
    opt = GAN_OPTIM[method]
    opt_g, sched_g = make_optimizer(g, opt["lr"], 10, "sgd", 0.9, opt["weight_decay"],
                                    exclude=AUX_KEYS)
    opt_d, sched_d = make_optimizer(d, 1e-4, 10, "adam", weight_decay=0.0, head_lr_scale=1.0,
                                    betas=(0.9, 0.99))
    step = make_gan_train_step(_g_forward(g, method), CLASSES, 255, threshold, 0.1, 1.0,
                               gt_norm_by_labeled_max=method == "gan")
    _, _, m = step(TrainState(1, g, opt_g, sched_g), TrainState(1, d, opt_d, sched_d),
                   {r: _on(b, dev, dtype) for r, b in roles.items()}, None)

    def host(module):
        return {k: v.detach().double().cpu().clone() for k, v in module.state_dict().items()}

    return {k: v.detach().double().cpu() for k, v in m.items()}, host(g), host(d)


# phase 4g's hold on the discriminator after its Adam step: Adam moves an
# element by about lr whatever its gradient's size, so where a gradient is
# float32 rounding away from 0 its sign, and the element's step, may flip;
# the CPU's float32 step leaves up to 2.4e-4 of a conv weight's elements more
# than 1e-4 of the tensor's largest magnitude from the float64 step's. At
# most D_OFF_SHARE of a tensor's elements may sit that far from the CPU's.
D_OFF_SHARE = 1e-3


def check_gan_step_card_vs_cpu(method, size=65, n=5, card=torch.device("cuda")) -> None:
    """Phase 4g for one method: PSPNet-50 with its aux head at ``size`` px
    and a discriminator, batch 2, frame_delta ``n``, float32 with TF32 off,
    one step on the card and on the CPU from the same state with the same
    keep masks (one a Dropout, drawn on the CPU; the same masks in the
    generator's two forwards and the discriminator's four calls) and a
    threshold_st that passes one sample of two (gan_threshold). Losses
    within rtol 1e-4; st_count 1 on both; every generator parameter and BN
    statistic within 1e-4 of its tensor's largest magnitude, or, where it
    is larger, within STEP_FLOOR_FACTOR times the CPU float32 step's own
    distance to the same step in float64 (4t's floor rule: the gan
    config's LR is 2.5 times 4t's, and BN's backward at 9x9 maps amplifies
    the rounding of the larger update); of each discriminator tensor at
    most D_OFF_SHARE of the elements farther than 1e-4; what the step
    changed within 4t's float32 floor rule; every aux parameter equal to
    its start to the bit on both. (``card`` the CPU rehearses
    it.)"""
    model = random_model("pspnet", torch.float32, seed=4, image_size=size, with_aux=True)
    disc = init_from_generator_(S4GANDiscriminator(CLASSES), torch.Generator().manual_seed(9))
    p0 = {**{f"g.{k}": v.detach().double().clone() for k, v in model.state_dict().items()},
          **{f"d.{k}": v.detach().double().clone() for k, v in disc.state_dict().items()}}
    roles, masks = gan_roles(size, n), {}
    threshold, margin = gan_threshold(model, disc, roles, masks, method)
    runs = {}
    t0 = time.perf_counter()
    for name, dev, dtype in (("card", card, torch.float32),
                             ("cpu", torch.device("cpu"), torch.float32),
                             ("f64", torch.device("cpu"), torch.float64)):
        m, sg, sd = gan_step(model, disc, roles, masks, dev, method, threshold, dtype)
        runs[name] = (m, {**{f"g.{k}": v for k, v in sg.items()},
                          **{f"d.{k}": v for k, v in sd.items()}})
    log(f"  threshold_st {threshold:.6f} (margin {margin:.2e} to the nearer confidence); "
        f"three steps (card, CPU float32, CPU float64) in {time.perf_counter() - t0:.1f} s; "
        f"{len(masks)} dropout masks")
    (mc, sc), (mh, sh), (m64, _) = runs["card"], runs["cpu"], runs["f64"]
    losses = ("loss", "loss_s", "loss_ce", "loss_fm", "loss_st", "loss_d")
    rel = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k])) for k in losses}
    counts = (int(mc["st_count"]), int(mh["st_count"]), int(m64["st_count"]))
    log(f"  losses card | CPU | float64: " + "; ".join(
        f"{k} {float(mc[k]):.7f} | {float(mh[k]):.7f} | {float(m64[k]):.7f}" for k in losses)
        + f"; largest card vs CPU rel {max(rel.values()):.2e} (tol 1e-4); st_count {counts}")
    s64 = runs["f64"][1]
    d, d_limit, off, off_floor = {}, {}, {}, {}
    for k, ref in sh.items():
        scale = float(ref.abs().max()) if ref.numel() else 0.0
        if scale == 0.0:
            continue
        if k.startswith("d."):
            # Adam's share of elements off by more than 1e-4 of the scale
            off[k] = float(((sc[k] - ref).abs() > 1e-4 * scale).double().mean())
            off_floor[k] = float(((ref - s64[k]).abs() > 1e-4 * scale).double().mean())
        else:
            d[k] = float((sc[k] - ref).abs().max()) / scale
            d_limit[k] = max(1e-4, STEP_FLOOR_FACTOR * float((ref - s64[k]).abs().max()) / scale)
    key, dkey = max(d, key=lambda k: d[k] / d_limit[k]), max(off, key=off.get)
    moved = {k for k in sh if not torch.equal(sh[k], p0[k])}
    moved_card = {k for k in sc if not torch.equal(sc[k], p0[k])}
    e, floor = step_rel(sc, sh, p0), step_rel(sh, s64, p0)
    limit = {k: max(STEP_ABS, STEP_FLOOR_FACTOR * floor.get(k, 0.0)) for k in e}
    worst = sorted(e, key=lambda k: e[k] / limit[k], reverse=True)[:3]
    aux = [k for k in p0 if k.startswith("g.aux.") and "running" not in k
           and "num_batches" not in k]
    aux_equal = all(torch.equal(s[k], p0[k]) for s in (sc, sh) for k in aux)
    log(f"  generator parameter or BN statistic closest to its limit: {key} {d[key]:.2e} of "
        f"its tensor's largest magnitude (limit {d_limit[key]:.2e}: 1e-4, or "
        f"{STEP_FLOOR_FACTOR:.0f} times the CPU float32 step's distance to float64); "
        f"largest {max(d.values()):.2e}; discriminator elements off by more "
        f"than 1e-4 of their tensor's largest magnitude: at most {off[dkey]:.2e} of a tensor "
        f"({dkey}; tol {D_OFF_SHARE:.0e}; CPU float32 vs float64 "
        f"{max(off_floor.values()):.2e}); the step's change: {len(e)} tensors moved "
        f"({len(moved_card)} on the card), card vs CPU median "
        f"{statistics.median(e.values()):.2e}, closest to the limit "
        + "; ".join(f"{k} {e[k]:.2e} | {limit[k]:.2e}" for k in worst)
        + f"; the {len(aux)} aux parameters equal to their start on both: {aux_equal}")
    ok = (max(rel.values()) <= 1e-4 and counts[0] == counts[1] == 1
          and all(d[k] <= d_limit[k] for k in d) and off[dkey] <= D_OFF_SHARE
          and moved == moved_card and all(e[k] <= limit[k] for k in e) and aux_equal
          and any(k.startswith("d.") for k in moved) and len(aux) == 5)
    if not ok:
        raise AssertionError(f"the {method} step on the card disagrees with the CPU")


def gan_phases(dev, root=None) -> dict:
    """Phases 4g, 19 and 20 in order on phase 14's tree (written when
    ``root`` is None); returns each full-width phase's result by tag."""
    for method in ("flow_gan", "gan"):
        log(f"[4g] the {method} step on the card against the CPU (PSPNet-50 with aux, 65 px, "
            f"float32, batch 2, frame_delta 5)")
        check_gan_step_card_vs_cpu(method)
    root = root or train_tree()
    results = {}
    for phase, tag, arch, layers, method, crop, steps, warmup, val in GAN_PHASES:
        t0 = time.perf_counter()
        log(f"[{phase}] {method} through run_gan_fit: PSPNet-50 float32 with its aux head, "
            f"batch 2, {round_train(crop, arch)} px crops of {FRAME_HW[0]}x{FRAME_HW[1]} frames"
            + (f", n = {FRAME_DELTA}" if method == "flow_gan" else "")
            + f", {GAN_OPTIM[method]}")
        results[tag] = train_phase(dev, root, tag, arch, layers, method, crop, steps, warmup,
                                   val)
        log(f"  phase {phase}: {time.perf_counter() - t0:.1f} s")
    return results


# --------------------------------------- evaluation: phases 18, 18k, 18c, 5p

# phase 18: (label, tag, method, no_cropping, train crop); the test crop is
# the rounded train crop, as apply_links links it
TEST_PHASES = (
    ("(a)", "pspnet_f32_test_crop", "flow_supervised", False, CROP),
    ("(b)", "pspnet_f32_test_whole", "flow_supervised", True, CROP),
    ("(c)", "pspnet_f32_test_supervised", "supervised", False, 873),
)
TEST_LIMIT = 2


def test_config(method, no_cropping, crop, n=FRAME_DELTA, frame_hw=FRAME_HW,
                limit=TEST_LIMIT) -> FitConfig:
    return default_fit_config(train_h=crop, train_w=crop, resize_h=frame_hw[0],
                              resize_w=frame_hw[1], frame_delta=n, no_cropping=no_cropping,
                              limit_test_batches=limit)


def test_phase(model, dev, root, tag, method, no_cropping, crop, n=FRAME_DELTA,
               frame_hw=FRAME_HW) -> dict:
    """Phase 18 (a), (b) or (c): run_test on the tree at ``root`` under
    torch.profiler (CUDA activity). Checks Runner.test's keys, finite
    metrics and the launches: K1 2 (n - 1) a sample (a) or a batch (b), K2
    and K3 never; nothing at all in (c). (Smaller arguments rehearse it on
    the CPU.)"""
    from torch.profiler import ProfilerActivity, profile as tprofile
    cfg = test_config(method, no_cropping, crop, n, frame_hw)
    prof = PhaseProfiler(sync=cuda_sync)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with tprofile(activities=[activity]) as tp:
        results = run_test(model, root, cfg, method, profiler=prof, device=dev)
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0
    region = "test_step" if no_cropping else "test_sample"
    samples = len(prof.recorded_durations[region])
    warps = 2 * (n - 1) if method == "flow_supervised" and cuda else 0
    expected = {"grid_sample_cuda": warps * samples, "grid_sample_backward_cuda": 0,
                "warp_chain_cuda": 0, "resize_quantize_int8_cuda": 0}
    keys = {f"test_{m}{k}_epoch" for m in ("miou", "macc", "accuracy") for k in (1, 2)}
    keys |= {"test_miou1_epoch_classes", "test_miou2_epoch_classes", "test_miou_epoch"}
    finite = all(np.all(np.isfinite(v)) for v in results.values())
    shown = {k: round(v, 4) for k, v in results.items() if not k.endswith("classes")}
    log(f"  {samples} {'batches' if no_cropping else 'samples'} in {total:.1f} s; "
        f"launches {counts} (expected {expected}); {shown}")
    if samples != 3 or counts != expected:
        raise AssertionError(f"the test launched {counts} over {samples} samples")
    if set(results) != keys or not finite:
        raise AssertionError(f"run_test returned {sorted(results)}, finite {finite}")
    trace = os.path.join(PROFILE_DIR, f"{tag}_trace.json")
    os.makedirs(PROFILE_DIR, exist_ok=True)
    tp.export_chrome_trace(trace)
    dt = device_time(trace, samples)
    per = {k: prof.sum(k) / samples for k in (region, "crop_forward", "crop_probs_to_host",
                                              "crop_canvas")}
    log(f"  seconds a {'batch' if no_cropping else 'sample'}: {per[region]:.3f}"
        + ("" if no_cropping else
           f" (device call {per['crop_forward']:.3f}, probabilities to the host "
           f"{per['crop_probs_to_host']:.3f}, float64 canvas and resize "
           f"{per['crop_canvas']:.3f}; the rest is the loader and the crop cutting)")
        + f"; device busy {dt['busy_ms']:.1f} ms of it, idle share "
        f"{1 - dt['busy_ms'] / (1e3 * per[region]):.1%}, {dt['kernels']:.0f} kernels, "
        f"device-to-host copies {dt['d2h_ms']:.1f} ms (torch.profiler); peak memory "
        f"{peak_gb:.2f} GB")
    return {"launches": counts, "samples": samples, "seconds": per, "total_s": total,
            "s_a_sample": per[region], "peak_gb": peak_gb, "results": results, **dt}


def test_grids(root, no_cropping, n=FRAME_DELTA, frame_hw=FRAME_HW) -> tuple:
    """The grids run_test first gives K1, float32 on the CPU, and the frame
    size the encoder sees: (a)'s first sample's crop grids, mvs_left
    (n - 1, 28, 27, 27, 2) at the 433 px test crop, or (b)'s first batch's
    whole-frame grids, (n - 1, batch_size_test, 67, 120, 2) at (433, 650)."""
    cfg = test_config("flow_supervised", no_cropping, CROP, n, frame_hw)
    ds = FlowDataset("test", root, os.path.join(root, "list", "all", "test.txt"),
                     transform=flow_transforms(cfg, "pspnet")["test"], frame_delta=n)
    rng = np.random.default_rng(0)
    batch = collate([ds.get(i, rng) for i in range(cfg.batch_size_test)])
    h, w = batch["frame_prev"].shape[1:3]
    if no_cropping:
        return torch.as_tensor(batch["mvs_left"]).contiguous(), (h, w)
    crop = round_train(cfg.train_h, "pspnet")
    _, _, ml, _ = _crop_stack(batch, crop_offsets(h, w, crop, crop), crop, crop)
    return torch.as_tensor(ml).contiguous(), (crop, crop)


def check_test_kernels(dev, root, c=4096, n=FRAME_DELTA, frame_hw=FRAME_HW) -> tuple:
    """Phase 18k: K1 in float32 at the flow test's shapes. (a)'s crop
    route: (28, 55, 55, C) -> 27x27 (the chains' heads) and (28, 27, 27, C)
    -> 27x27 (their steps); (b)'s whole frames: (1, 55, 82, C) -> 67x120
    and (1, 67, 120, C) -> 67x120 (more points than source pixels at the
    heads, so x is not read evict-first). Each bit-equal to the plain
    version on the route's own first grids, random grids, the identity and
    a corner-clamped grid, and timed on its own grids beside bound, plain
    version and F.grid_sample."""
    g = torch.Generator().manual_seed(2)
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    errs, res = {}, {}
    for route, no_cropping in (("test", False), ("test whole", True)):
        ml, frame = test_grids(root, no_cropping, n, frame_hw)
        batch, grid_hw = ml.shape[1], tuple(ml.shape[2:4])
        # PSPNet-50's encoding: three stride-2 stages, each ceil(s / 2)
        feat_hw = tuple((s - 1) // 8 + 1 for s in frame)
        ident = torch.as_tensor(default_grid(grid_hw[0] * 16, grid_hw[1] * 16))[None]
        grids = {"head": ml[0], "step": ml[1],
                 "random": torch.rand((batch,) + grid_hw + (2,), generator=g) * 2.2 - 1.1,
                 "identity": ident.expand(batch, -1, -1, -1),
                 "corner": torch.full((batch,) + grid_hw + (2,), -1.5)}
        grids = {k: v.to(dev).contiguous() for k, v in grids.items()}
        xs = {part: torch.randn((batch,) + hw + (c,), generator=g).to(dev)
              for part, hw in (("head", feat_hw), ("step", grid_hw))}
        for x in xs.values():
            for what, grid in grids.items():
                note_err(errs, "grid_sample_cuda", torch.float32, check_k1(
                    f"K1 float32 x{tuple(x.shape)} {route} {what} grid{tuple(grid.shape)}",
                    x, grid, False))
        for part, x in xs.items():
            res[f"grid_sample_cuda ({route} {part}, float32)"] = time_k1(
                x, x.permute(0, 3, 1, 2).contiguous(), grids[part], grids[part], False, flush,
                cpm)
        del xs, grids
    log_timing(res)
    return errs, res


def _clear_share(probs: np.ndarray) -> tuple:
    """(pixels whose top-2 probability gap exceeds 2e-4, twice the
    tolerance; their share)."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2e-4
    return clear, float(clear.mean())


def test_card_vs_cpu(no_cropping=False, n=5, frame_hw=(128, 192), crop=65, seed=1) -> None:
    """Phase 18c: run_test (flow_supervised) in float32 on the card
    against the CPU on a small tree. The crop route: each sample's crop
    probabilities within 1e-4 and its map equal away from near-ties (a
    top-2 gap of twice that). ``no_cropping``: each whole-frame batch's
    probabilities (the eval step's logits, softmaxed) within 1e-4, its map
    equal away from near-ties, and its counts equal where the map is. The
    metrics equal where every map is."""
    root = os.path.join(DATA_DIR, "test_tree_small")
    if not os.path.isdir(root):
        generate_synthetic_dataset(root, num_frames=24, size=frame_hw, frame_delta=n,
                                   num_labeled=12)
    cfg = test_config("flow_supervised", no_cropping, crop, n, frame_hw, limit=None)
    cpu_model = random_model("pspnet", torch.float32, seed)
    gpu_model = copy.deepcopy(cpu_model)
    names = ("make_flow_test_crop_fn", "flow_sliding_window_test", "make_flow_eval_step")
    originals = {k: getattr(fit, k) for k in names}
    res = {}
    for dev, m in ((torch.device("cpu"), cpu_model), (torch.device("cuda"), gpu_model)):
        # each sample's (probabilities on the device, map) or each batch's
        # (probabilities, map, counts)
        probs, maps, counts = [], [], []

        def recording_make(*args, **kw):
            fn = originals["make_flow_test_crop_fn"](*args, **kw)

            def recording(*a):
                out = fn(*a)
                probs.append(out.cpu().numpy())
                return out
            return recording

        def recording_test(*args, **kw):
            maps.append(originals["flow_sliding_window_test"](*args, **kw))
            return maps[-1]

        def recording_eval(model, classes, ignore_index, feature_based, no_warp):
            step = originals["make_flow_eval_step"](model, classes, ignore_index,
                                                    feature_based, no_warp)

            def recording(state, batch):
                with torch.no_grad(), full_precision_f32():
                    logits = flow_train_forward(model, batch, None, False, feature_based,
                                                no_warp)
                p = torch.softmax(logits.float(), dim=-1)[..., :classes].cpu().numpy()
                probs.append(p)
                maps.append(p.argmax(-1))
                out = step(state, batch)
                counts.append([out[k].cpu().numpy() for k in ("intersection", "union",
                                                             "target")])
                return out
            return recording

        patches = ({"make_flow_eval_step": recording_eval} if no_cropping else
                   {"make_flow_test_crop_fn": recording_make,
                    "flow_sliding_window_test": recording_test})
        for k, v in patches.items():
            setattr(fit, k, v)
        try:
            summary = run_test(m, root, cfg, "flow_supervised", device=dev)
        finally:
            for k, v in originals.items():
                setattr(fit, k, v)
        res[dev.type] = (probs, maps, counts, summary)
    (pc, mc, cc, sc), (pg, mg, cg, sg) = res["cpu"], res["cuda"]
    if len(pc) != len(pg) or len(mc) != len(mg) or not pc:
        raise AssertionError(f"{len(pc)} CPU calls, {len(pg)} card calls")
    err = max(float(np.abs(a - b).max()) for a, b in zip(pg, pc))
    differ = clear_share = 0
    if no_cropping:
        what = f"{len(pc)} whole-frame batches of {pc[0].shape[1:3]}"
        for p, a, b in zip(pc, mg, mc):
            clear, share = _clear_share(p)
            differ += int(((a != b) & clear).sum())
            clear_share += share / len(pc)
        for a, b, x, y in zip(mg, mc, cg, cc):
            if np.array_equal(a, b) and not all(np.array_equal(u, v) for u, v in zip(x, y)):
                raise AssertionError(f"equal maps, different counts: {x} {y}")
    else:
        offs = crop_offsets(*frame_hw, crop, crop)
        what = f"{len(pc)} samples of {len(offs)} crops"
        for p, a, b in zip(pc, mg, mc):
            canvas = np.zeros(frame_hw + (CLASSES,))
            count = np.zeros(frame_hw + (1,))
            for (h, w), q in zip(offs, p):
                canvas[h:h + crop, w:w + crop] += q
                count[h:h + crop, w:w + crop] += 1
            clear, share = _clear_share(canvas / count)
            differ += int(((a != b) & clear).sum())
            clear_share += share / len(pc)
    same = all(np.array_equal(a, b) for a, b in zip(mg, mc))
    log(f"  {what}: probabilities max_abs_err {err:.3e} (tol 1e-4); maps "
        f"{'equal' if same else 'not all equal'}, {differ} pixels differ away from near-ties "
        f"({clear_share:.4f} of pixels clear); test_miou_epoch card "
        f"{sg['test_miou_epoch']:.6f}, CPU {sc['test_miou_epoch']:.6f}")
    if not err <= 1e-4 or differ:
        raise AssertionError(f"run_test differs between card and CPU: {err}, {differ}")
    if same and sg != sc:
        raise AssertionError(f"equal maps, different metrics: {sg} {sc}")


# 5p's composed clip against make_flow_predict_fn: the same function in
# bf16 with its roundings in other places (the warp phase's resize back to
# the feature size, the blend in a call of its own), which the decoder
# carries into the logits; maps are held where the top-2 logit gap exceeds
# COMPOSED_GAP of the window's largest |logit|. A random-weight model's
# logits lie close together, so that leaves about 0.59 of the pixels
# (PERF.md §2): at least half must be clear, and at least 0.98 of all
# pixels equal, so that the exclusion cannot hide a broken map.
COMPOSED_GAP = 2.0 ** -5
COMPOSED_MIN_CLEAR = 0.5
COMPOSED_MIN_EQUAL = 0.98


def phases_phase(model, wins, dev, n=FRAME_DELTA, size=SIZE, frame_hw=(512, 512)) -> dict:
    """Phase 5p: profile_predict_phases on phase 5's second window (bf16
    PSPNet-50, 513 px, n = 25), one composed clip of the phase functions
    counted and held against make_flow_predict_fn, and
    make_cached_flow_predict_fn(fused_argmax=False) against the fused
    functions over phase 5's first windows."""
    dg = default_grid(*frame_hw)
    w = wins[1]
    fns = make_flow_phase_fns(model, n, out_size=(size, size), default_grid=dg, device=dev)
    variables = model.state_dict()  # on the card, where make_flow_phase_fns moved it
    times = profile_predict_phases(model, variables, w, n, out_size=(size, size),
                                   default_grid=dg, device=dev)
    log(f"  ms a clip by region (mean of 5 after a warm-up, synchronised): "
        f"{ {k: round(1e3 * v, 3) for k, v in times.items()} }; "
        f"sum {1e3 * sum(times.values()):.3f}")
    sync(dev)
    reset_launch_counts()
    f, f2 = fns["encode"](variables, w["frame_prev"]), fns["encode"](variables, w["frame_next"])
    maps = fns["fuse"](f, f2, fns["warp_chain"](f, w["mvs_left"]),
                       fns["warp_chain"](f2, w["mvs_right"]))
    composed = fns["decode"](variables, maps)
    sync(dev)
    counts = launch_counts()
    on_card = int(dev.type == "cuda")
    expected = {"grid_sample_cuda": 3 * on_card, "grid_sample_backward_cuda": 0,
                "warp_chain_cuda": 2 * on_card, "resize_quantize_int8_cuda": 0}
    if counts != expected:
        raise AssertionError(f"a composed clip launched {counts}, expected {expected}")
    ref = make_flow_predict_fn(model, n, out_size=(size, size), default_grid=dg, device=dev)(
        variables, w["frame_prev"], w["frame_next"], w["mvs_left"], w["mvs_right"])

    with full_precision_f32():
        logits = window_logits(model, w, n, dg, size, dev).float()
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > COMPOSED_GAP * float(logits.abs().max())
    differ = int(((composed != ref) & clear).sum())
    equal, share = float((composed == ref).float().mean()), float(clear.float().mean())
    log(f"  composed phases vs make_flow_predict_fn: {equal:.6f} of pixels equal, {differ} "
        f"differ away from near-ties ({share:.4f} clear; at least {COMPOSED_MIN_CLEAR} clear "
        f"and {COMPOSED_MIN_EQUAL} equal required)")
    if differ or share < COMPOSED_MIN_CLEAR or equal < COMPOSED_MIN_EQUAL:
        raise AssertionError(f"composed phases: {differ} pixels differ away from near-ties, "
                             f"{share} clear, {equal} equal")
    log(f"  one composed clip's launches {counts} (expected {expected})")
    out, resized = {}, {}
    for fused in (True, False):
        full, cached = make_cached_flow_predict_fn(model, n=n, out_size=(size, size),
                                                   default_grid=dg, fused_argmax=fused,
                                                   device=dev)
        with recording_epilogue(resized, (size, size)):
            m0, enc = full(variables, wins[0]["frame_prev"], wins[0]["frame_next"],
                           wins[0]["mvs_left"], wins[0]["mvs_right"])
            r0 = resized.pop("last", None)
            m1, _ = cached(variables, enc, wins[1]["frame_next"], wins[1]["mvs_left"],
                           wins[1]["mvs_right"])
            r1 = resized.pop("last", None)
        out[fused] = (m0, m1, r0, r1)
    for i in range(2):
        got, want, own = out[False][i], out[True][i], out[False][2 + i].float()
        top2 = torch.topk(own, 2, dim=-1).values
        # the two epilogues' float32 sums differ at most in order, so after
        # the one rounding to bf16 each resized logit by at most one ulp:
        # only a top-2 gap of two ulps (of the larger magnitude) can turn
        mag = torch.maximum(top2[..., 0].abs(), top2[..., 1].abs())
        ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        tie = (top2[..., 0] - top2[..., 1]) <= 2 * ulp
        own_map = torch.argmax(own, dim=-1).to(torch.int32)
        differ = int(((got != want) & ~tie).sum())
        log(f"  fused_argmax=False vs True, window {i}: "
            f"{float((got == want).float().mean()):.6f} of pixels equal, {differ} differ away "
            f"from two-ulp ties of the unfused epilogue's own bf16 logits "
            f"({float(tie.float().mean()):.4f} of pixels such ties); the unfused maps "
            f"{'are' if torch.equal(own_map, got) else 'are NOT'} the argmax of those logits")
        if differ or not torch.equal(own_map, got):
            raise AssertionError(f"fused_argmax=False, window {i}: {differ} pixels differ "
                                 f"away from ties")
    return {"times": times, "launches": counts}


@contextlib.contextmanager
def recording_epilogue(resized: dict, out_size):
    """Keep, as resized["last"], the last output at ``out_size`` of
    resize_bilinear inside video/flow_model.py (the unfused epilogue's
    resized logits, before its argmax)."""
    original = flow_model.resize_bilinear

    def recording(x, size, *a, **kw):
        y = original(x, size, *a, **kw)
        if tuple(y.shape[-3:-1]) == tuple(out_size):
            resized["last"] = y
        return y

    flow_model.resize_bilinear = recording
    try:
        yield
    finally:
        flow_model.resize_bilinear = original


def evaluation_phases(dev, root, model, wins) -> tuple:
    """Phases 18, 18k, 18c and 5p in order, on phase 14's tree at ``root``
    and phase 5's bf16 ``model`` and windows; returns (18k's errors, 18k's
    timing, phase 18's results by tag, 5p's)."""
    log(f"[18] the test at full width through run_test: PSPNet-50 float32, "
        f"{FRAME_HW[0]}x{FRAME_HW[1]} frames, limit_test_batches = {TEST_LIMIT}")
    test_model = random_model("pspnet", torch.float32, seed=7)
    results = {}
    for label, tag, method, no_cropping, crop in TEST_PHASES:
        t0 = time.perf_counter()
        log(f"[18] {label} {method}" + (", no_cropping" if no_cropping else "")
            + f", {crop} px test crop")
        results[tag] = test_phase(test_model, dev, root, tag, method, no_cropping, crop)
        log(f"  phase 18 {label}: {time.perf_counter() - t0:.1f} s")
    test_model.cpu()
    del test_model
    log("[18k] K1 at the flow test's shapes (28 crops and whole frames, C = 4096, float32)")
    errs, timing = check_test_kernels(dev, root)
    log("[18c] run_test card vs CPU (float32, 128x192 frames, n = 5): the crop route "
        "(65 px crops), then no_cropping")
    test_card_vs_cpu()
    test_card_vs_cpu(no_cropping=True)
    log(f"[5p] profile_predict_phases: PSPNet-50 bf16, {SIZE} px key frames, "
        f"n = {FRAME_DELTA}")
    phases = phases_phase(model, wins, dev)
    model.cpu()
    return errs, timing, results, phases


# ----------------------------------------------------------- U2PL: 4u, 21

# phase 4u's contrastive settings: the config's (256 queries, 50 negatives,
# the thresholds and ranks), with max_enqueue and the bank's caps cut so that
# a class's ring wraps within two semi steps at 65 px
U2PL_4U = ContrastiveConfig(max_enqueue=48)
U2PL_4U_CAPS = dict(bank_capacity=64, bank_class0_capacity=96)
U2PL_LOSSES = ("loss", "sup_loss", "unsup_loss", "contra_loss")
# the share of a semi step's decision pixels (pseudo-labels and the three
# entropy masks) that the card's own teacher outputs may move against the
# CPU's: near-ties of float32 values at an argmax or an order statistic; a
# fault would move many more
U2PL_FLIP_SHARE = 1e-3
# phase 21's device time by family: TRAIN_FAMILIES with U2PL's sorts (the
# OHEM threshold, the entropy percentiles, the class ranks) and top-k, and
# the gathers and scatters of the anchors and the bank
# (after the convolutions and products: cuDNN's wgrad kernels are "indexed")
_PRODUCTS = [name for name, _ in TRAIN_FAMILIES].index("matrix products") + 1
U2PL_FAMILIES = (TRAIN_FAMILIES[:_PRODUCTS] + (
    ("sorts and top-k (OHEM, entropy percentiles, class ranks, key subsets)",
     ("sort", "Sort", "radix", "Radix", "topk", "TopK", "bitonic")),
    ("gathers and scatters (anchors, negatives, the bank)",
     ("index", "Index", "gather", "scatter", "Scatter")),)
    + tuple(f for f in TRAIN_FAMILIES[_PRODUCTS:] if f[0] != "OHEM sort"))


class HostDraws(U2PLDraws):
    """U2PLDraws whose uniforms come from CPU generators and are then moved
    to ``device``: runs on the card and on the CPU with the same seeds draw
    the same values (each device applies them to its own masks and
    counts). The augmentation coin is fixed below 0.5: the cutmix is
    taken."""

    def __init__(self, device):
        super().__init__(torch.device("cpu"), 11, 12, 13)
        self.target = device

    def _u(self, gen, n, dtype=torch.float64):
        return super()._u(gen, n, dtype).to(self.target)

    def coin(self):
        return torch.full((), 0.25, dtype=torch.float64, device=self.target)


U2PL_KINDS = ("sup", "semi (aliased, cutmix taken)", "semi (true_ema)")


@contextlib.contextmanager
def teacher_tape(teacher, replay=None):
    """Inside the block, each call of ``teacher`` runs its own forward (its
    BN statistics move as they would) and keeps a host copy of the outputs
    in the yielded list; with ``replay`` (another run's list) it returns
    that run's outputs of the same call instead, on this device in this
    dtype, so that every mask and threshold computed from the teacher is
    the other run's."""
    tape, orig = [], teacher.forward

    def forward(x):
        out = orig(x)
        tape.append({k: v.detach().double().cpu() for k, v in out.items()})
        if replay is None:
            return out
        ref = replay[len(tape) - 1]
        return {k: ref[k].to(v.device, v.dtype) for k, v in out.items()}

    teacher.forward = forward
    try:
        yield tape
    finally:
        del teacher.forward


def u2pl_decisions(tape, n_l=2, epoch_frac=0.5):
    """A semi step's decisions from a teacher tape (its eval-mode call on
    the unlabeled batch, then its training-mode call on the joint one):
    the pseudo-labels (argmax), and the entropy masks at the unsupervised
    drop percentile and at alpha_t and 100 - alpha_t of the step
    (ops/u2pl.py), each a flat bool tensor, as float32 computes them."""
    pred_u, pred_all = tape[0]["pred"].float(), tape[1]["pred"].float()
    entropy = softmax_entropy(pred_all[n_l:])
    valid = torch.ones_like(entropy, dtype=torch.bool)
    alpha = np.float32(20.0) * (np.float32(1.0) - np.float32(epoch_frac))
    drop = np.float32(100.0) - np.float32(20.0) * (np.float32(1.0) - np.float32(epoch_frac))
    out = {"pseudo-labels": torch.argmax(pred_u, -1).flatten()}
    for name, p, keep_above in (("unsupervised drop", drop, True), ("low entropy", alpha, False),
                                ("high entropy", np.float32(100.0) - alpha, True)):
        t = masked_percentile(entropy, valid, torch.tensor(p))
        out[name] = ((entropy >= t) if keep_above else (entropy <= t)).flatten()
    return out


def u2pl_moved(state, dev, dtype):
    """A copy of a U2PLState on ``dev`` in ``dtype``: both models (an aliased
    teacher stays aliased), the optimizer's state, the bank (float32)."""
    st = copy.deepcopy(state)
    for m in (st.student.model, st.teacher):
        m.to(dev, dtype)
        for mod in m.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = dtype
        if dev.type == "cuda":
            m.to(memory_format=torch.channels_last)
    for per_param in st.student.optimizer.state.values():
        for k, v in per_param.items():
            if torch.is_tensor(v):
                per_param[k] = v.to(dev, dtype)
    b = st.bank
    b.buffer, b.counts, b.ptrs = b.buffer.to(dev), b.counts.to(dev), b.ptrs.to(dev)
    return st


def u2pl_record(state, metrics=None) -> tuple:
    """(metrics, the student's and the teacher's state_dict, the bank's
    counts, pointers and keys, whether the teacher's parameters are the
    student's tensors), on the CPU in float64."""
    def host(module):
        return {k: v.detach().double().cpu().clone() for k, v in module.state_dict().items()}

    params = dict(state.student.model.named_parameters())
    aliased = all(p is params[n] for n, p in state.teacher.named_parameters())
    b = state.bank
    return ({k: v.detach().double().cpu() for k, v in (metrics or {}).items()},
            host(state.student.model), host(state.teacher),
            (b.counts.cpu().clone(), b.ptrs.cpu().clone(), b.keys.double().cpu().clone()),
            aliased)


def u2pl_step(state, kind, batch, dev, dtype, draws) -> tuple:
    """Phase 4u's step ``kind`` on ``state`` (in place): the sup step; the
    sync and a semi step; or sync_teacher(alias=False) and a true_ema semi
    step (rel_step 3: decay 0.75). The config's SGD and OHEM with the aux
    loss at 0.4, the cutmix, epoch_frac 0.5, ``draws`` (HostDraws).
    Returns ``u2pl_record`` after it."""
    common = (CLASSES, U2PL_4U, 255, 0.4, 0.7, 100000, "cutmix", 80.0, 1.0, 0.99)
    sup, semi = make_u2pl_steps(*common)
    _, semi_ema = make_u2pl_steps(*common, true_ema=True)
    batch = {r: _on(b, dev, dtype) for r, b in batch.items()}
    if kind == "sup":
        _, m = sup(state, batch, None)
    else:
        aliased = kind.startswith("semi (aliased")
        sync_teacher(state, alias=aliased)
        step, rel = (semi, 0) if aliased else (semi_ema, 3)
        _, m = step(state, batch, None, 0.5, rel, draws=draws)
    return u2pl_record(state, m)


def step_rel_l2(a: dict, b: dict, p0: dict) -> dict:
    """Per tensor that ``b``'s step moved: ||a - b|| / ||b - p0|| (L2), how
    far ``a``'s change is from ``b``'s relative to the size of ``b``'s
    change as a whole."""
    out = {}
    for k, ref in b.items():
        scale = float(torch.linalg.vector_norm(ref - p0[k])) if ref.numel() else 0.0
        if scale > 0.0:
            out[k] = float(torch.linalg.vector_norm(a[k] - ref)) / scale
    return out


def check_u2pl_step_card_vs_cpu(size=65, card=torch.device("cuda")) -> None:
    """Phase 4u: PSPNet-50 with its aux and rep heads and a teacher of its
    own init, ``size`` px, batch 2 + 2, float32 with TF32 off, the config's
    SGD (lr 1e-4, the heads at 10x). The trajectory sup step, sync + semi
    step, sync(alias=False) + true_ema semi step runs on the CPU in
    float32; each step also runs on the card and on the CPU in float64
    from a copy of the CPU's state before it, so the devices differ by that
    step's rounding only; every dropout takes one keep mask a module and
    input shape and every draw comes from CPU generators (HostDraws), the
    same for all. The teacher's outputs, from which every mask, threshold
    and pseudo-label is computed, are the CPU's on every run
    (``teacher_tape``): the card's own are held within 1e-4 of their scale
    or STEP_FLOOR_FACTOR times the CPU float32 outputs' distance to
    float64's, and the pixels where they would have moved a decision (near-ties at an
    argmax or an order statistic) are named, at most U2PL_FLIP_SHARE of
    them. After each step: losses within rtol 1e-4; every student
    and teacher parameter and BN statistic within 1e-4 of its tensor's
    largest magnitude or, where larger, within STEP_FLOOR_FACTOR times the
    CPU float32 step's distance to float64; what the step changed, per
    tensor, within STEP_FLOOR_FACTOR times the CPU float32 change's L2
    distance to float64's (never tighter than STEP_ABS), relative to the
    change's L2 size (4t's rule, in L2: by the largest element, one
    channel of a BN that normalises over 36 values, the PPM's 3x3 bin at
    batch 4, moves by up to a quarter of its change between float32 and
    float64 on one device, so a single sample's floor can be 100x too
    tight there); the bank's counts and pointers equal and its
    keys within 1e-4 of their scale; after the semi step the teacher's
    parameters are the student's tensors on both, after the true_ema step
    their own. (``card`` the CPU rehearses it.)"""
    model = init_from_generator_(build_model("pspnet", classes=CLASSES, layers=50,
                                             semisupervised=True),
                                 torch.Generator().manual_seed(4))
    teacher = init_from_generator_(build_model("pspnet", classes=CLASSES, layers=50,
                                               semisupervised=True),
                                   torch.Generator().manual_seed(5))
    batches = []
    for seed in (3, 8, 10):
        lab, unl = train_batch(seed=seed, size=size), train_batch(seed=seed + 1, size=size)
        batches.append({"l": {k: lab[k] for k in ("frame_current", "label")},
                        "u": {"frame_current": unl["frame_current"]}})
    masks, cpu = {}, torch.device("cpu")
    s = _fresh(model, masks, cpu, torch.float32)
    opt, sched = make_optimizer(s, 1e-4, 10)
    state = create_u2pl_state(s, opt, sched, _fresh(teacher, masks, cpu, torch.float32),
                              num_classes=CLASSES, max_enqueue=U2PL_4U.max_enqueue,
                              **U2PL_4U_CAPS)
    log(f"  {U2PL_4U}; caps {U2PL_4U_CAPS}")
    bad, contra = [], []
    for kind, batch in zip(U2PL_KINDS, batches):
        t0 = time.perf_counter()
        _, s0, t0d, _, _ = u2pl_record(state)
        on_card, in_f64 = (u2pl_moved(state, card, torch.float32),
                           u2pl_moved(state, cpu, torch.float64))
        with teacher_tape(state.teacher) as tape:
            mh, sh, th, bh, ah = u2pl_step(state, kind, batch, cpu, torch.float32,
                                           HostDraws(cpu))
        with teacher_tape(on_card.teacher, tape) as card_tape:
            mc, sc, tc, bc, ac = u2pl_step(on_card, kind, batch, card, torch.float32,
                                           HostDraws(card))
        with teacher_tape(in_f64.teacher, tape) as f64_tape:
            m64, s64, t64, b64, _ = u2pl_step(in_f64, kind, batch, cpu, torch.float64,
                                              HostDraws(cpu))
        contra.append(float(mh["contra_loss"]))
        # the card's own teacher outputs against the CPU's, which every run
        # used, within 1e-4 of their scale or STEP_FLOOR_FACTOR times the CPU
        # float32 outputs' distance to float64's own; the decisions they would
        # have moved are named
        t_ratio, t_err = {}, {}
        for i, (o, r, f) in enumerate(zip(card_tape, tape, f64_tape)):
            for k in r:
                scale = float(r[k].abs().max())
                t_err[f"{i}.{k}"] = float((o[k] - r[k]).abs().max()) / scale
                t_ratio[f"{i}.{k}"] = t_err[f"{i}.{k}"] / max(
                    1e-4, STEP_FLOOR_FACTOR * float((r[k] - f[k]).abs().max()) / scale)
        t_key = max(t_ratio, key=t_ratio.get)
        flips, flipped, pixels = {}, 0, 0
        if kind != "sup":
            own, ref = u2pl_decisions(card_tape), u2pl_decisions(tape)
            for name, r in ref.items():
                where = torch.nonzero(own[name] != r).flatten().tolist()
                flips[name] = where[:8] + (["..."] if len(where) > 8 else [])
                flipped, pixels = flipped + len(where), pixels + r.numel()
        rel = {k: abs(float(mc[k]) - float(mh[k])) / max(abs(float(mh[k])), 1e-30)
               for k in U2PL_LOSSES if float(mh[k]) or float(mc[k])}
        d, limit, e, e_limit = {}, {}, {}, {}
        for net, c, h, f, p0 in (("s", sc, sh, s64, s0), ("t", tc, th, t64, t0d)):
            for k, ref in h.items():
                scale = float(ref.abs().max()) if ref.numel() else 0.0
                if scale == 0.0 or "num_batches" in k:
                    continue
                d[f"{net}.{k}"] = float((c[k] - ref).abs().max()) / scale
                limit[f"{net}.{k}"] = max(1e-4, STEP_FLOOR_FACTOR
                                          * float((ref - f[k]).abs().max()) / scale)
            ch, floor = step_rel_l2(c, h, p0), step_rel_l2(h, f, p0)
            for k, v in ch.items():
                e[f"{net}.{k}"] = v
                e_limit[f"{net}.{k}"] = max(STEP_ABS, STEP_FLOOR_FACTOR * floor.get(k, 0.0))
        key = max(d, key=lambda k: d[k] / limit[k])
        counts_eq = torch.equal(bc[0], bh[0]) and torch.equal(bc[1], bh[1])
        kscale = float(bh[2].abs().max())
        keys_err = float((bc[2] - bh[2]).abs().max()) / kscale if kscale else 0.0
        f64_counts = torch.equal(b64[0], bh[0]) and torch.equal(b64[1], bh[1])
        want_alias = kind.startswith("semi (aliased")
        log(f"  {kind} ({time.perf_counter() - t0:.1f} s): losses card | CPU | float64 "
            + "; ".join(f"{k} {float(mc[k]):.7f} | {float(mh[k]):.7f} | {float(m64[k]):.7f}"
                        for k in U2PL_LOSSES)
            + f"; largest card vs CPU rel {max(rel.values()):.2e} (tol 1e-4)")
        log(f"    closest to its limit: {key} {d[key]:.2e} of its largest magnitude (limit "
            f"{limit[key]:.2e}); bank counts {bc[0].tolist()} pointers {bc[1].tolist()} "
            f"equal to the CPU's: {counts_eq} (float64's too: {f64_counts}); keys "
            f"{keys_err:.2e} of their scale (tol 1e-4); teacher aliased card {ac} CPU {ah}")
        log(f"    the teacher's outputs (the CPU's used on every run): the card's own within "
            f"{t_err[t_key]:.2e} of their scale at call.output {t_key}, {t_ratio[t_key]:.2f} of "
            f"its limit (1e-4, or {STEP_FLOOR_FACTOR:.0f}x the CPU float32 outputs' distance "
            f"to float64's)"
            + (f"; pixels where they would have moved a decision {flips} (at most "
               f"{U2PL_FLIP_SHARE:.0e} of {pixels})" if flips else ""))
        worst = sorted(e, key=lambda k: e[k] / e_limit[k], reverse=True)[:4]
        card_floor, by_max = {}, {}
        for net, c, h, f, p0 in (("s", sc, sh, s64, s0), ("t", tc, th, t64, t0d)):
            card_floor.update({f"{net}.{k}": v for k, v in step_rel_l2(c, f, p0).items()})
            by_max.update({f"{net}.{k}": v for k, v in step_rel(c, h, p0).items()})
        mkey = max(by_max, key=by_max.get)
        log("    the step's change (L2) closest to its limit, card vs CPU | limit | card vs "
            "float64: " + "; ".join(f"{k} {e[k]:.2e} | {e_limit[k]:.2e} | "
                                    f"{card_floor.get(k, 0.0):.2e}" for k in worst)
            + f"; by the largest element (4t's form, for the record) {mkey} {by_max[mkey]:.2e}")
        if not (max(rel.values()) <= 1e-4 and t_ratio[t_key] <= 1.0
                and flipped <= U2PL_FLIP_SHARE * pixels
                and all(d[k] <= limit[k] for k in d)
                and all(e[k] <= e_limit[k] for k in e) and counts_eq and keys_err <= 1e-4
                and ac == ah == want_alias):
            bad.append(kind)
    counts, ptrs = state.bank.counts, state.bank.ptrs
    wrapped = bool((ptrs < counts).any())
    log(f"  {len(masks)} dropout masks; a ring wrapped: {wrapped} (counts {counts.tolist()}, "
        f"pointers {ptrs.tolist()}); contra_loss of the semi steps {contra[1:]}")
    if bad or not wrapped or not all(contra[1:]):
        raise AssertionError(f"U2PL card vs CPU: {bad}; wrapped {wrapped}; contra {contra}")


def u2pl_phase(dev, root, tag, layers=101, crop=873, epochs=4, steps=2,
               frame_hw=FRAME_HW, remat=False) -> dict:
    """Phase 21: ``contrastive`` at full width through run_contrastive_fit
    on the tree at ``root``: PSPNet-``layers`` with its aux and rep heads
    (random weights, the teacher its own init), the repository's
    configuration (configs/train_contrastive.yaml over train_base.yaml:
    float32, batch 2 + 2, the ``crop`` through round_train, SGD lr 1e-4 and
    weight decay 1e-4 with the heads at 10x, OHEM with the aux loss at 0.4,
    the contrastive settings, the (5, 50000, 256) bank, cutmix, drop
    percent 80, ema_decay 0.99, the aliased teacher), ``epochs`` epochs of
    ``steps`` steps with sup_only_epoch 1: 2 sup steps, the sync, then the
    semi steps (2 warm-up, 2 timed, then the last epoch's under
    torch.profiler: the window opens after the epoch before it has read its
    metrics back and closes after the last step, before the last read-back),
    validation every second epoch over one crop. Checks:
    no launch of K1, K2, K3 or K1-bwd; every loss finite; contra_loss
    non-zero on a semi step; no class count above its cap and none growing
    by more than max_enqueue a step; the teacher's parameters the
    student's tensors after every semi step; its BN statistics its own;
    validation served the teacher; the profiled window traced kernels and
    no copy to the host. ``remat``: every bottleneck of the student
    rematerialised (phase 25b)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    model = init_from_generator_(build_model("pspnet", classes=CLASSES, layers=layers,
                                             semisupervised=True, remat=remat),
                                 torch.Generator().manual_seed(7))
    cfg = default_fit_config(train_h=crop, train_w=crop, resize_h=frame_hw[0], resize_w=frame_hw[1],
                             max_epochs=epochs, limit_train_batches=steps, sup_only_epoch=1,
                             check_val_every_n_epoch=2, limit_val_batches=1)
    total_steps = epochs * steps
    profiled = steps
    log(f"  PSPNet-{layers} with aux and rep heads "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters), "
        f"{round_train(crop, 'pspnet')} px crops, batch {cfg.batch_size} + {cfg.batch_size}; "
        f"{cfg.contrastive}; caps {cfg.bank_capacity} / {cfg.bank_class0_capacity}")
    records = []
    tp = tprofile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else []))

    def on_step(step, state, metrics):
        params = dict(state.student.model.named_parameters())
        aliased = all(p is params[n] for n, p in state.teacher.named_parameters())
        records.append((metrics, state.bank.counts.clone(), state.teacher_synced and aliased))
        if step == total_steps - 1:
            _sync(dev)
            tp.stop()

    class OpenWindow(FitHooks):
        """Starts the profiler once the epoch before the last has read its
        metrics back, so the window holds the last epoch's steps alone."""

        def end_epoch(self, epoch, state, record, global_step, early_stop):
            if epoch == epochs - 2:
                _sync(dev)
                tp.start()

    prof = PhaseProfiler(sync=lambda: _sync(dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_contrastive_fit(model, root, cfg, profiler=prof, on_step=on_step, device=dev,
                                  hooks=OpenWindow())
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    state = summary["state"]
    step_s = prof.recorded_durations["train_step"]
    load_s = prof.recorded_durations["train_load"]
    sup_ms = [1e3 * v for v in step_s[:steps]]
    semi_ms = [1e3 * v for v in step_s[steps:]]
    timed = semi_ms[2:len(semi_ms) - profiled]
    wait_ms = 1e3 * statistics.median(load_s[steps + 2:total_steps - profiled])
    host = [({k: float(v) for k, v in m.items() if v.dim() == 0}, c.cpu(), a)
            for m, c, a in records]
    caps = torch.tensor(state.bank.caps)
    grow = [int((h[1] - p[1]).max()) for p, h in zip(host, host[1:])]
    finite = all(np.isfinite(v) for m, _, _ in host for v in m.values())
    contra = [m["contra_loss"] for m, _, _ in host[steps:]]
    over = any(bool((c > caps).any()) for _, c, _ in host)
    aliased = [a for _, _, a in host[steps:]]
    s_bn = {k: v for k, v in state.student.model.state_dict().items() if "running" in k}
    t_bn = {k: v for k, v in state.teacher.state_dict().items() if "running" in k}
    bn_own = sum(not torch.equal(v, t_bn[k]) for k, v in s_bn.items())
    params = dict(state.student.model.named_parameters())
    equal = all(torch.equal(p, params[n]) for n, p in state.teacher.named_parameters())
    log(f"  {summary['steps']} steps in {total:.1f} s with validation; ms a sup step "
        f"{[round(v, 1) for v in sup_ms]}, a semi step {[round(v, 1) for v in semi_ms]} "
        f"(timed median {statistics.median(timed):.1f}); the step's wait for its batches "
        f"{wait_ms:.1f} ms (median); peak memory {peak_gb:.2f} GB")
    log(f"  losses by step (loss, sup, unsup, contra): "
        f"{[[round(m[k], 5) for k in U2PL_LOSSES] for m, _, _ in host]}; bank counts "
        f"{host[-1][1].tolist()} of caps {list(state.bank.caps)}, the most a class grew in a "
        f"step {max(grow)} (max_enqueue {cfg.contrastive.max_enqueue}); teacher aliased "
        f"after every semi step {aliased}, its parameters equal to the student's {equal}, its "
        f"BN statistics its own in {bn_own} of {len(s_bn)} tensors; validation served "
        f"{summary['served']}; launches {counts}")
    if any(counts.values()) or not finite or not any(contra) or over \
            or max(grow) > cfg.contrastive.max_enqueue or not all(aliased) or not equal \
            or bn_own != len(s_bn) or [s for _, s in summary["served"]] != ["teacher"] * 2:
        raise AssertionError("phase 21's checks failed")

    os.makedirs(PROFILE_DIR, exist_ok=True)
    trace = os.path.join(PROFILE_DIR, f"{tag}_trace.json")
    tp.export_chrome_trace(trace)
    with open(os.path.join(PROFILE_DIR, f"{tag}_profile.txt"), "w") as f:
        f.write(tp.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    # the window holds the last epoch's steps and none of the epochs'
    # read-backs, so any copy to the host in it is a step's
    d2h = sum(e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"] for e in events)
    dt = device_time(trace, profiled)
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3 \
        if kernels else float("nan")
    spans = {name: [] for name, _ in U2PL_FAMILIES}
    for e in kernels:
        fam = next(name for name, pats in U2PL_FAMILIES if any(p in e["name"] for p in pats))
        spans[fam].append((e["ts"], e["ts"] + e["dur"]))
    families = {name: union_us(v) / (1e3 * profiled) for name, v in spans.items()}
    log(f"  profiler over {profiled} semi steps: device busy {dt['busy_ms']:.1f} ms a step of "
        f"{span / profiled:.1f} (idle share {1 - dt['busy_ms'] * profiled / span:.1%}); "
        f"{dt['kernels']:.0f} kernels a step; ms a step by family "
        f"{ {k: round(v, 3) for k, v in families.items()} }")
    log(f"  copies to the host in the window: {d2h}")
    log(tp.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    if dev.type == "cuda" and not kernels:
        raise AssertionError("the profiled window traced no kernel of the U2PL steps")
    if dev.type == "cuda" and d2h:
        raise AssertionError(f"a U2PL step read back to the host: {d2h} copies")
    return {"launches": counts, "step_ms": statistics.median(timed), "sup_ms": sup_ms,
            "semi_ms": semi_ms, "wait_ms": wait_ms, "peak_gb": peak_gb,
            "busy_ms": dt["busy_ms"], "span_ms": span / profiled, "family_ms": families,
            "layers": layers}


def u2pl_phases(dev, root=None) -> dict:
    """Phases 4u and 21 on phase 14's tree (written when ``root`` is None);
    returns phase 21's result by tag."""
    log("[4u] one sup step, the sync, one semi step and a true_ema semi step on the card "
        "against the CPU (PSPNet-50 with aux and rep heads, 65 px, float32, batch 2 + 2)")
    t0 = time.perf_counter()
    check_u2pl_step_card_vs_cpu()
    log(f"  phase 4u: {time.perf_counter() - t0:.1f} s")
    root = root or train_tree()
    t0 = time.perf_counter()
    tag = "pspnet101_f32_contrastive"
    log(f"[21] contrastive through run_contrastive_fit: PSPNet-101 float32 with aux and rep "
        f"heads, 873 px crops of {FRAME_HW[0]}x{FRAME_HW[1]} frames")
    result = u2pl_phase(dev, root, tag)
    log(f"  phase 21: {time.perf_counter() - t0:.1f} s")
    return {tag: result}


def test_alone() -> int:
    """--test: build csrc/warp.cu and the codec, write phase 14's tree, then
    phases 18, 18k, 18c and 5p."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "jpeg"])
    dev = torch.device("cuda")
    root = train_tree()
    model = random_model("pspnet", torch.bfloat16, seed=0)
    wins = clip_windows(FRAME_DELTA, (512, 512), 3, SIZE, dev)
    evaluation_phases(dev, root, model, wins)
    return 0


# ------------------------------------------------------------------ the CLI

CLI_CONFIGS = ("train_base", "train_flow_supervised", "dataset_flow", "pspnet")
# the keys the JAX Runner writes to metrics.json after a flow fit
# (floodseg_tpu/cli/runner.py: fit's best validation, test, predict)
CLI_METRICS = ({"best_val_miou", "best_epoch", "test_miou_epoch"}
               | {f"test_{m}{k}_epoch" for m in ("miou", "macc", "accuracy") for k in (1, 2)}
               | {f"test_miou{k}_epoch_classes" for k in (1, 2)}
               | {"predict_time_mean", "predict_time_sum", "frames", "predict_miou1_epoch",
                  "predict_macc1_epoch", "predict_accuracy1_epoch",
                  "predict_miou1_epoch_classes", "frames_per_second"})
CLI_KERNELS = ("grid_sample_cuda", "grid_sample_backward_cuda", "warp_chain_cuda",
               "resize_quantize_int8_cuda")


def flat_cpu(payload: dict) -> dict:
    """A checkpoint payload (core/checkpoint.py) flattened by name, every
    tensor copied to the host."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}.{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}[{i}]", x)
        else:
            out[prefix] = v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v

    walk("", payload)
    return out


def cpu_payload(state) -> dict:
    """A state's checkpoint payload, flattened with every tensor on the host."""
    from floodseg_tpu_torch.core.checkpoint import state_payload
    return flat_cpu(state_payload(state))


def payload_bits_differ(a: dict, b: dict) -> int:
    """Entries of two flattened payloads that differ (tensors by integer
    view)."""
    if a.keys() != b.keys():
        return len(a.keys() ^ b.keys())
    n = 0
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
                x.reshape(-1).view(torch.uint8) if x.is_floating_point() else x,
                y.reshape(-1).view(torch.uint8) if y.is_floating_point() else y))
        else:
            same = x == y
        n += not same
    return n


def cli_phase(dev, root) -> dict:
    """Phase 22: the CLI in process on the card, ``floodseg_tpu_torch.cli.main``
    (``run`` is ``main`` returning its Runner), PSPNet-50 flow_supervised from
    configs/{train_base,train_flow_supervised,dataset_flow,pspnet}.yaml on
    phase 14's tree, 2 epochs of 2 steps, one val and one test batch: ``fit``
    (the test and the crop-route predict after it), ``test --ckpt_path
    <run>/checkpoints/last``, then ``predict`` on the same checkpoint with
    ``--model.no_cropping true --model.int8_decode true``. Checks: K1,
    K1-bwd, K2 and K3 each launched; the state restore_best and the test
    restore equal, bit for bit, the states the fit saved at those epochs;
    the CLI's predict maps equal run_flow_predict's on the same weights,
    by integer equality; metrics.json has the JAX Runner's keys."""
    from floodseg_tpu_torch.cli import main as cli
    from floodseg_tpu_torch.cli.runner import Runner
    from floodseg_tpu_torch.core.checkpoint import CheckpointManager

    log_dir = os.path.join(os.path.dirname(DATA_DIR), "cli_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    here = os.path.dirname(os.path.abspath(__file__))
    common = [a for n in CLI_CONFIGS
              for a in ("--config", os.path.join(here, "configs", f"{n}.yaml"))]
    common += ["--data.data_root", root, "--data.predict_v_id", "synth",
               "--trainer.max_epochs", "2", "--trainer.limit_train_batches", "2",
               "--trainer.limit_val_batches", "1", "--trainer.limit_test_batches", "1",
               "--trainer.log_dir", log_dir, "--trainer.run_name", "cli"]
    run_dir = os.path.join(log_dir, "cli")
    last = os.path.join(run_dir, "checkpoints", "last")
    saved, spent = {}, {}
    # seconds in the Runner's parts (the model's draw on the host, the fit,
    # its checkpoint saves, restores, the test and predict), and this
    # phase's own copies of what the fit saves
    timed = [(Runner, "_build_model"), (Runner, "fit"), (CheckpointManager, "save"),
             (CheckpointManager, "restore"), (Runner, "test"), (Runner, "predict")]
    originals = {(owner, name): getattr(owner, name) for owner, name in timed}

    def timer(owner, name):
        orig = originals[(owner, name)]

        def wrapped(*args, **kwargs):
            if name == "save":  # what the fit saves, kept on the host
                t0 = time.perf_counter()
                saved[args[2]] = cpu_payload(args[1])
                spent["copies kept by this phase"] = (spent.get("copies kept by this phase", 0.0)
                                                      + time.perf_counter() - t0)
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return wrapped

    launches, seconds, parts = {}, {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    for owner, name in timed:
        setattr(owner, name, timer(owner, name))
    try:
        for name, argv in (
                ("fit", ["fit", *common, "--data.resize_factor_predict", "0.5"]),
                ("test", ["test", *common, "--ckpt_path", last]),
                ("predict", ["predict", *common, "--ckpt_path", last, "--model.no_cropping",
                             "true", "--model.int8_decode", "true", "--model.save_images",
                             "true", "--model.save_video", "false"])):
            reset_launch_counts()
            spent.clear()
            t0 = time.perf_counter()
            runner = cli.run(argv)
            torch.cuda.synchronize(dev)
            # the subcommand's own seconds: its wall time less this phase's
            # host copies of what it saves, which the CLI does not make
            copies = spent.get("copies kept by this phase", 0.0)
            seconds[name] = time.perf_counter() - t0 - copies
            launches[name] = launch_counts()
            parts[name] = dict(spent)
            log(f"  {name}: {seconds[name]:.1f} s wall less {copies:.2f} s of this phase's "
                f"copies, launches {launches[name]}; seconds in "
                f"{ {k: round(v, 2) for k, v in spent.items()} }")
            if name == "fit":
                with open(os.path.join(run_dir, "metrics.json")) as f:
                    keys = set(json.load(f))
                if keys != CLI_METRICS:
                    raise AssertionError(f"metrics.json keys {sorted(keys ^ CLI_METRICS)} "
                                         f"differ from the JAX Runner's")
                best = os.path.basename(runner.ckpt.best_path)
                best_epoch = int(best.split("-")[0][len("epoch="):])
                differ = payload_bits_differ(cpu_payload(runner.state), saved[best_epoch])
                epochs = runner.fit_summary["epochs"]
                log(f"  restore_best ({best}): {differ} entries differ from the state the "
                    f"fit saved at epoch {best_epoch}; metrics.json has the JAX Runner's "
                    f"{len(keys)} keys; epochs' steps and read-back "
                    f"{sum(e['epoch_time'] for e in epochs):.2f} s, last train loss "
                    f"{epochs[-1]['train_loss']:.4f}; crop-route predict "
                    f"{runner.logger.summary['predict_time_sum']:.2f} s over "
                    f"{runner.logger.summary['frames']} frames")
            elif name == "test":
                differ = payload_bits_differ(cpu_payload(runner.state), saved[max(saved)])
                log(f"  test --ckpt_path last: {differ} entries differ from the state the fit "
                    f"saved at epoch {max(saved)}; test mIoU "
                    f"{runner.logger.summary['test_miou_epoch']:.4f}")
            if name in ("fit", "test") and differ:
                raise AssertionError(f"phase 22's {name} restored a state that differs from "
                                     f"the saved one ({differ} entries)")
    finally:
        for (owner, name), orig in originals.items():
            setattr(owner, name, orig)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    # the same weights through run_flow_predict, on the same device
    frame, out = runner.predict_size()
    direct = os.path.join(log_dir, "direct")
    model = runner.state.model
    d, m = runner.cfg.data, runner.cfg.model
    ref = run_flow_predict(model, model.state_dict(), root, "synth", frame_delta=d.frame_delta,
                           resize=out, crop=(m.test_h, m.test_w), no_cropping=True,
                           num_classes=m.classes, int8_decode=True,
                           classes_ignore=d.data_classes_ignore, save_images_dir=direct,
                           workers=d.workers, seed=runner.cfg.trainer.seed, frame_size=frame)
    pngs = os.path.join(run_dir, "frames", "synth")
    names = sorted(os.listdir(direct))
    if sorted(os.listdir(pngs)) != names or not names:
        raise AssertionError("the CLI's predict and run_flow_predict wrote different frames")
    unequal = sum(int((imread(os.path.join(pngs, n)) != imread(os.path.join(direct, n))).sum())
                  for n in names)
    summary = runner.logger.summary
    log(f"  predict (no_cropping, int8 decoder, frames {frame} -> maps {out}): "
        f"{summary['frames']} frames, {summary['frames_per_second']:.2f} frames/s; "
        f"{unequal} map pixels differ from run_flow_predict's on the same weights "
        f"({ref['frames']} frames)")
    if unequal or ref["frames"] != summary["frames"]:
        raise AssertionError(f"phase 22's predict maps differ from run_flow_predict's "
                             f"({unequal} pixels)")
    total = {k: sum(c[k] for c in launches.values()) for k in CLI_KERNELS}
    missing = [k for k in CLI_KERNELS if not total[k]]
    if missing:
        raise AssertionError(f"phase 22 launched no {missing}")
    log(f"  phase 22 launches {total}; peak memory {peak:.2f} GB on {nvidia_smi_line()}")
    del runner, model
    torch.cuda.empty_cache()
    norm = cli_normalize_on_device(common)
    total = {k: total[k] + norm["launches"][k] for k in CLI_KERNELS}
    return {"launches": total, "launches_by_subcommand": launches, "seconds": seconds,
            "parts": parts, "peak_gb": peak, "normalize_on_device": norm}


def cli_normalize_on_device(common) -> dict:
    """Phase 22's fit with ``--data.normalize_on_device true`` and the same
    fit normalised on the host: one epoch of 2 steps under ``no_cropping``
    (the test skipped; predict the whole-frame route). The frames each
    train step is given reach the card as float16; the weights and BN
    statistics after the fit within 4t's rule of the host-normalised
    fit's, the floor 23a's: the host fit on each batch reversed (both
    fits' steps see the same float32 frames, whole grey levels, which
    float16 holds; OHEM's selection turns a rounding into a step of its
    own, so two fits of one thing on the card differ by more than
    STEP_ABS)."""
    from floodseg_tpu_torch.cli import main as cli
    from floodseg_tpu_torch.cli.runner import Runner
    from floodseg_tpu_torch.train import fit as fit_module

    seen, p0 = [], {}
    normalize, build = fit_module.normalize_frames, Runner._build_model

    def recording(batch):
        seen.append({k: (v.dtype, v.device.type) for k, v in batch.items()
                     if k.startswith("frame_")})
        return normalize(batch)

    reverse = contextlib.ExitStack()

    def first_model(runner):
        model = build(runner)
        p0.setdefault("state", {k: v.detach().clone() for k, v in model.state_dict().items()})
        if runner.cfg.trainer.run_name.endswith("reversed"):
            reverse.enter_context(reversed_samples(model))
        return model

    args = [*common, "--trainer.max_epochs", "1", "--trainer.limit_test_batches", "0",
            "--model.no_cropping", "true", "--model.save_images", "false",
            "--model.save_video", "false"]
    states, launches = {}, {}
    fit_module.normalize_frames, Runner._build_model = recording, first_model
    try:
        for name, on in (("normalize_on_device", True), ("host", False),
                         ("host_reversed", False)):
            reset_launch_counts()
            t0 = time.perf_counter()
            with reverse:
                runner = cli.run(["fit", *args, "--trainer.run_name", name,
                                  "--data.normalize_on_device", str(on).lower()])
            torch.cuda.synchronize()
            launches[name] = launch_counts()
            states[name] = {k: v.detach().cpu().clone()
                            for k, v in runner.state.model.state_dict().items()}
            log(f"  fit --data.normalize_on_device {str(on).lower()} ({name}): "
                f"{time.perf_counter() - t0:.1f} s, train loss "
                f"{runner.fit_summary['epochs'][0]['train_loss']:.6f}, launches "
                f"{launches[name]}")
            del runner
    finally:
        fit_module.normalize_frames, Runner._build_model = normalize, build
    log(f"  the train steps' frames as the step receives them: {seen}")
    if len(seen) != 2 or any(v != (torch.float16, "cuda") for d in seen for v in d.values()) \
            or any(len(d) != 3 for d in seen):
        raise AssertionError("phase 22: normalize_on_device's frames did not reach the card "
                             "as float16")
    floor = step_rel(states["host_reversed"], states["host"], p0["state"])
    change_within("22 fit with normalize_on_device against the host-normalised fit",
                  states["normalize_on_device"], states["host"], p0["state"], floor)
    torch.cuda.empty_cache()
    return {"launches": {k: sum(v[k] for v in launches.values()) for k in CLI_KERNELS},
            "frames": [str(d) for d in seen]}


def cli_alone() -> int:
    """--cli: build warp.cu, resize.cu and the codec, write phase 14's tree,
    then phase 22."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "resize", "jpeg"])
    log("[22] the CLI on the card: fit, test --ckpt_path last, predict (no_cropping, int8)")
    cli_phase(torch.device("cuda"), train_tree())
    return 0


# ---------------------------------------------- data parallelism: phase 23

# (a) and (b): the flow_supervised step of phase 14 (PSPNet-50 float32 with
# its aux head, 433 px crops, global batch 2) for DDP_STEPS steps and
# DDP_VAL validation frames; the contrastive check's crop, which two
# processes on the card hold with their teachers and banks; (c) the
# windows of DP predict: one a rank, then a remainder of one
DDP_STEPS, DDP_VAL = 2, 2
DDP_U2PL_CROP = 321
# the contrastive check, 2 ranks against 1. Its anchors and negatives are
# drawn by index among the pixels of entropy and probability masks, and a
# mask bit that float32 rounding flips at a near-tie moves the draws, so no
# reordering of the batch computes the same step to measure a floor with;
# two one-rank runs on the card differ too (atomics in the backward). The
# limits lie between what sound runs read and what the planted faults of
# ``--ddp-faults`` read, largest sound reading / smallest fault reading
# that the limit separates (an H100 80GB HBM3 at 700 W; PERF.md): the sup
# and unsup losses, rtol (4.7e-5 / 8.1e-3); the contrastive loss and the
# total with it, rtol (4.8e-4 / 8.1e-3); the memory bank's count of each
# class, relative (3.1e-3 / 0.115); what the steps changed per tensor in
# L2 (4u's form) in the median tensor (7.8e-3 / 0.48) and in the largest
# (0.149 / 0.95). The entropy percentiles taken per rank move only the
# bank and the ranks' agreement
DDP_LOSS_REL = 1e-4
DDP_CONTRA_REL = 5e-3
DDP_BANK_REL = 1e-2
DDP_U2PL_L2 = 5e-2
DDP_U2PL_L2_MAX = 0.5
# the planted faults: BatchNorm statistics over a rank's own samples, every
# rank drawing its dropout masks at its own shape (the global masks' first
# rows), the entropy percentiles over a rank's own pixels
DDP_FAULTS = ("bn_local", "dropout_unsliced", "percentile_local")
DDP_WINDOWS = 3
DDP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ddp")
DDP_TREE = os.path.join(DATA_DIR, "ddp_predict_tree")
# run_predict's summary keys that hold times, not results
PREDICT_TIMES = ("predict_time_mean", "predict_time_sum", "frames_per_second")
DDP_KERNELS = ("grid_sample_cuda", "grid_sample_backward_cuda", "warp_chain_cuda",
               "resize_quantize_int8_cuda")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(part: str, size: int, backend: str, timeout: float, expect_fail=False):
    """``part`` on ``size`` rank processes of this script (``--ddp-rank``),
    every one on cuda:0, rendezvousing through FLOODSEG_COORDINATOR on a
    free localhost port with ``backend`` (``ddp_rank``). Returns each
    rank's result (what it saved); for parts joined by commas, run one after
    another in the same processes (one start-up for all), {part: each
    rank's result}. A rank that fails, or a launch that outlives
    ``timeout``, raises, unless ``expect_fail`` (then the outputs come back
    with the exit codes, None for a rank killed at the timeout)."""
    os.makedirs(DDP_DIR, exist_ok=True)
    prefix = os.path.join(DDP_DIR, part)
    env = {**os.environ, "FLOODSEG_MULTIHOST": "1",
           "FLOODSEG_COORDINATOR": f"localhost:{_free_port()}",
           "FLOODSEG_NUM_PROCESSES": str(size), "LOCAL_RANK": "0"}
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, "--ddp-rank", part, backend, prefix],
                              env={**env, "FLOODSEG_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(size)]
    outs, codes = [], []
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
                codes.append(p.returncode)
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, out in enumerate(outs):
        with open(f"{prefix}.rank{r}.log", "w") as f:
            f.write(out)
    if expect_fail:
        return codes, outs
    for r, (code, out) in enumerate(zip(codes, outs)):
        if code != 0:
            raise AssertionError(f"phase 23 {part}: rank {r} of {size} exited {code}:\n"
                                 f"{out[-6000:]}")
    results = {p: [torch.load(os.path.join(DDP_DIR, f"{p}.rank{r}.pt"), weights_only=False)
                   for r in range(size)] for p in part.split(",")}
    return results if "," in part else results[part]


class _ReversedBatches:
    """A train loader whose batches come with their samples in reverse
    order (the grid chains on their second dim, the host ids too)."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for b in self.loader:
            yield {k: (v.flip(1) if k in ("mvs_left", "mvs_right") else v.flip(0))
                   if torch.is_tensor(v) else np.ascontiguousarray(v[::-1])
                   for k, v in b.items()}


@contextlib.contextmanager
def reversed_samples(model):
    """Inside: run_flow_fit's train batches reversed (``_ReversedBatches``)
    and every Dropout of ``model`` drawing its mask as it would and
    reversing it with them, so that the step computes what it computes on
    the batch in order, its sums over the batch in another order: the
    float32 floor of a reordering, which is what data parallelism does to
    the sums."""
    orig = fit.train_loaders

    def loaders(*args, **kwargs):
        ls, steps = orig(*args, **kwargs)
        return {k: _ReversedBatches(v) for k, v in ls.items()}, steps

    def draw(mod, args):
        x = args[0]
        if mod.training and 0.0 < mod.rate < 1.0 and mod.generator is not None:
            shape = [1 if d in mod.broadcast_dims else s for d, s in enumerate(x.shape)]
            keep = torch.rand(shape, generator=mod.generator, device=x.device) < 1.0 - mod.rate
            mod.keep = keep if 0 in mod.broadcast_dims else keep.flip(0)

    def clear(mod, args, out):
        mod.keep = None

    hooks = [h for m in model.modules() if isinstance(m, Dropout)
             for h in (m.register_forward_pre_hook(draw), m.register_forward_hook(clear))]
    fit.train_loaders = loaders
    try:
        yield
    finally:
        fit.train_loaders = orig
        for h in hooks:
            h.remove()


def ddp_fit(dev, root, world, batch, reverse=False) -> dict:
    """run_flow_fit of phase 14's PSPNet-50 (seed 7, float32, aux head) on
    ``root`` over ``world`` (None: one device) with ``batch`` samples a
    rank: DDP_STEPS steps, DDP_VAL validation frames; ``reverse``: under
    ``reversed_samples``. Returns the state (on the host), the epoch's
    record, each step's synchronised ms, the launches, seconds and
    peak."""
    model = random_model("pspnet", torch.float32, seed=7, image_size=CROP, with_aux=True)
    cfg = default_fit_config(train_h=CROP, train_w=CROP, resize_h=FRAME_HW[0],
                             resize_w=FRAME_HW[1], frame_delta=FRAME_DELTA, max_epochs=1,
                             limit_train_batches=DDP_STEPS, limit_val_batches=DDP_VAL,
                             batch_size=batch)
    prof = PhaseProfiler(sync=lambda: torch.cuda.synchronize(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with reversed_samples(model) if reverse else contextlib.nullcontext():
        summary = run_flow_fit(model, root, cfg, profiler=prof, device=dev, world=world)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    rec = summary["epochs"][0]
    return {"state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "record": {k: rec[k] for k in ("train_loss", "train_miou", "val_miou")},
            "step_ms": [round(1e3 * s, 1) for s in prof.recorded_durations["train_step"]],
            "launches": launch_counts(), "seconds": seconds,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def ddp_u2pl_batch(seed=11, size=DDP_U2PL_CROP) -> dict:
    """A global U2PL batch, 2 labeled + 2 unlabeled at ``size`` px, on the
    host (labels with 5% ignored)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, CLASSES, (2, size, size))
    labels = np.where(rng.random(labels.shape) < 0.05, 255, labels).astype(np.int32)
    frames = [rng.standard_normal((2, size, size, 3)).astype(np.float32) for _ in range(2)]
    return {"l": {"frame_current": frames[0], "label": labels}, "u": {"frame_current": frames[1]}}


@contextlib.contextmanager
def planted_fault(name, world):
    """Inside, the contrastive steps over ``world`` take the wrong
    data-parallel step ``name`` (one of DDP_FAULTS; None: none): the
    package's modules are patched in this process alone."""
    from floodseg_tpu_torch.models.layers import BatchNorm2d
    from floodseg_tpu_torch.parallel import shard
    from floodseg_tpu_torch.train import contrastive
    saved = {k: getattr(contrastive, k) for k in ("data_parallel", "masked_percentile")}
    if name in ("bn_local", "dropout_unsliced"):
        local = BatchNorm2d if name == "bn_local" else Dropout

        @contextlib.contextmanager
        def data_parallel(module, w):
            with saved["data_parallel"](module, w):
                for m in module.modules():
                    if isinstance(m, local):
                        m.world = None
                yield

        contrastive.data_parallel = data_parallel
    elif name == "percentile_local":
        contrastive.masked_percentile = lambda x, valid, q: saved["masked_percentile"](
            shard(x, world), shard(valid, world), q)
    elif name is not None:
        raise ValueError(f"no planted fault {name!r}")
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(contrastive, k, v)


def u2pl_p0() -> dict:
    """The student's floating-point state before ``ddp_u2pl``'s steps."""
    return {k: v.detach().clone() for k, v in init_from_generator_(
        build_model("pspnet", classes=CLASSES, layers=50, with_aux=True, semisupervised=True),
        torch.Generator().manual_seed(12)).state_dict().items() if v.is_floating_point()}


def u2pl_readings(two, one, p0=None) -> dict:
    """The contrastive check's readings of ``two`` (each rank's
    ``ddp_u2pl`` result) against ``one`` (a one-device result): the largest
    relative distance of the sup and unsup losses and of the contrastive
    and total loss over both steps, the tensors and bank counts in which
    the ranks differ, the bank counts' largest relative distance, and what
    the steps changed per tensor in L2 (``step_rel_l2``): the median and
    the largest tensor."""
    def rel(keys):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for a, b in zip(two[0]["losses"], one["losses"]) for k in keys)

    a, b = two[0], one
    ranks_differ = sum(not torch.equal(a["state"][k], r["state"][k])
                       for r in two[1:] for k in a["state"])
    ranks_differ += sum(not torch.equal(a["bank_counts"], r["bank_counts"]) for r in two[1:])
    bank = ((a["bank_counts"] - b["bank_counts"]).abs().double()
            / b["bank_counts"].double().clamp(min=1)).max()
    l2 = step_rel_l2(a["state"], b["state"], p0 if p0 is not None else u2pl_p0())
    largest = max(l2, key=l2.get)
    return {"loss_rel": rel(("sup_loss", "unsup_loss")),
            "contra_rel": rel(("contra_loss", "loss")), "ranks_differ": ranks_differ,
            "bank_rel": float(bank), "l2_median": statistics.median(l2.values()),
            "l2_largest": l2[largest], "l2_largest_tensor": largest}


def u2pl_failures(r) -> list:
    """The readings over their limits."""
    limits = {"loss_rel": DDP_LOSS_REL, "contra_rel": DDP_CONTRA_REL, "ranks_differ": 0,
              "bank_rel": DDP_BANK_REL, "l2_median": DDP_U2PL_L2,
              "l2_largest": DDP_U2PL_L2_MAX}
    return [k for k, v in limits.items() if r[k] > v]


def u2pl_line(r) -> str:
    return (f"sup/unsup losses rel {r['loss_rel']:.2e} (limit {DDP_LOSS_REL:g}), contrastive "
            f"and total rel {r['contra_rel']:.2e} ({DDP_CONTRA_REL:g}), {r['ranks_differ']} "
            f"tensors or banks differ between the ranks (0), bank counts rel "
            f"{r['bank_rel']:.2e} ({DDP_BANK_REL:g}), what the steps changed in L2: median "
            f"tensor {r['l2_median']:.2e} ({DDP_U2PL_L2:g}), largest {r['l2_largest']:.2e} "
            f"({DDP_U2PL_L2_MAX:g}, {r['l2_largest_tensor']})")


def ddp_u2pl(dev, world, fault=None) -> dict:
    """One contrastive sup step, the sync and one semi step of PSPNet-50
    with its aux and rep heads (teacher of its own init) over ``world``
    (None: one device) on this rank's share of ``ddp_u2pl_batch``, the
    contrastive loss divided by 2 either way; the draws from the step's
    generators, the same on every rank; ``fault``: under
    ``planted_fault``. Returns each step's losses, the student's state
    after the semi step, the bank's counts, launches, seconds and peak."""
    from floodseg_tpu_torch.parallel import shard_batch
    model = init_from_generator_(build_model("pspnet", classes=CLASSES, layers=50,
                                             with_aux=True, semisupervised=True),
                                 torch.Generator().manual_seed(12)).to(dev)
    teacher = init_from_generator_(build_model("pspnet", classes=CLASSES, layers=50,
                                               with_aux=True, semisupervised=True),
                                   torch.Generator().manual_seed(13)).to(dev)
    model.to(memory_format=torch.channels_last)
    teacher.to(memory_format=torch.channels_last)
    cfg = default_fit_config()
    opt, sched = make_optimizer(model, cfg.lr, 10)
    state = create_u2pl_state(model, opt, sched, teacher, num_classes=CLASSES,
                              max_enqueue=cfg.contrastive.max_enqueue)
    sup, semi = make_u2pl_steps(CLASSES, ContrastiveConfig(num_devices=2), 255, 0.4,
                                world=world)
    glob = ddp_u2pl_batch()
    batch = {r: {k: torch.as_tensor(v, device=dev)
                 for k, v in (shard_batch(b, world) if world else b).items()}
             for r, b in glob.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with planted_fault(fault, world):
        state, m_sup = sup(state, batch, fit.step_generator(0, 0))
        sync_teacher(state)
        state, m_semi = semi(state, batch, fit.step_generator(0, 1), 0.5, 0)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"losses": [{k: float(v) for k, v in m.items() if k.endswith("loss")}
                       for m in (m_sup, m_semi)],
            "counts": m_semi["target"].cpu(), "bank_counts": state.bank.counts.cpu(),
            "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                      if v.is_floating_point()},
            "launches": launch_counts(), "seconds": seconds,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def ddp_predict_tree() -> str:
    """Phase 23c's predict tree from the port's writer: DDP_WINDOWS windows
    of 512 px frames, n = 25, with its palette (list/colors.txt)."""
    shutil.rmtree(DDP_TREE, ignore_errors=True)
    generate_synthetic_dataset(DDP_TREE, num_frames=DDP_WINDOWS * FRAME_DELTA + 1,
                               size=(512, 512), frame_delta=FRAME_DELTA, num_labeled=2)
    return DDP_TREE


@contextlib.contextmanager
def dp_maps_spy():
    """Inside: every DP predict function that run_flow_predict makes
    (parallel/mesh.py::make_dp_predict_fn) also puts the maps it returns
    (uint8, on the host) in the list yielded, batch by batch."""
    from floodseg_tpu_torch.train import predict as predict_mod
    orig = predict_mod.make_dp_predict_fn
    maps = []

    def make(predict_fn, world):
        dp = orig(predict_fn, world)

        def spied(*args):
            out = dp(*args)
            maps.append(torch.as_tensor(out).to(torch.uint8).cpu())
            return out

        return spied

    predict_mod.make_dp_predict_fn = make
    try:
        yield maps
    finally:
        predict_mod.make_dp_predict_fn = orig


def plain_predict(model, dev, int8, png_dir, video_path) -> dict:
    """What run_flow_predict's whole-frame route runs on one device, with
    the non-cached make_flow_predict_fn, which every rank runs, in place of
    the cached pair: run_predict over the same dataset, loader, palette and
    outputs. Returns run_predict's summary."""
    ds = FlowDataset("predict", DDP_TREE, None, type="u", frame_delta=FRAME_DELTA,
                     transform=build_test_transform(None, (SIZE, SIZE), normalize=False),
                     predict_v_id="synth")
    fn = make_flow_predict_fn(model, n=FRAME_DELTA, out_size=(SIZE, SIZE),
                              default_grid=ds.default_grid, int8_decode=int8, device=dev)
    loader = DataLoader(ds, batch_size=1, num_workers=4,
                        device_put=lambda b: device_put(b, dev))
    colors = np.loadtxt(os.path.join(DDP_TREE, "list", "colors.txt")).astype("uint8")
    return run_predict(fn, model.state_dict(), loader, CLASSES, colors=colors,
                       save_images_dir=png_dir, video_path=video_path)


def ddp_predict(dev, world, out_dir, plain=False) -> dict:
    """run_flow_predict of ``ddp_predict_tree``'s video with phase 5's
    PSPNet-50 bf16 (seed 0) at 513 px, n = 25, on the whole-frame route
    (no_cropping), over ``world`` (None: one device, the cached route;
    ``plain``: one device through ``plain_predict``), with the bf16 and
    then the int8 decoder, the PNGs to out_dir/DEC/png and the AVI to
    out_dir/DEC.avi. Returns for each decoder the summary less its times,
    the frames/s, the maps the DP predict functions returned (none on one
    device), launches, seconds and peak. The weights are on the card in
    the builders' layout (channels_last) before the variables are taken,
    so that every route convolves the same tensors."""
    model = random_model("pspnet", torch.bfloat16, seed=0).to(dev)
    model.to(memory_format=torch.channels_last)
    out = {}
    for dec in ("bf16", "int8"):
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        png_dir, video = os.path.join(out_dir, dec, "png"), os.path.join(out_dir, f"{dec}.avi")
        with dp_maps_spy() as maps:
            if plain:
                summary = plain_predict(model, dev, dec == "int8", png_dir, video)
            else:
                summary = run_flow_predict(
                    model, model.state_dict(), DDP_TREE, "synth", frame_delta=FRAME_DELTA,
                    resize=(SIZE, SIZE), no_cropping=True, num_classes=CLASSES,
                    int8_decode=dec == "int8", save_images_dir=png_dir, video_path=video,
                    workers=4, device=dev, world=world)
        torch.cuda.synchronize(dev)
        out[dec] = {"summary": {k: v for k, v in summary.items() if k not in PREDICT_TIMES},
                    "frames_per_second": summary.get("frames_per_second"),
                    "maps": list(maps), "launches": launch_counts(),
                    "seconds": time.perf_counter() - t0,
                    "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    return out


def ddp_rank(part: str, backend: str, prefix: str) -> int:
    """--ddp-rank PART BACKEND PREFIX: one rank of phase 23 (the
    environment of ``launch_ranks``): the rendezvous, then ``part`` on this
    rank, its result saved to PREFIX.rank{r}.pt. Under ``nccl`` the port's
    own (parallel/dist.py, which derives NCCL from the card); under
    ``gloo`` (several ranks on the one card, which NCCL refuses) this
    process makes the gloo group at the same address first, and the
    port's initialiser finds it made. ``nccl_probe``: one all-reduce, the
    error it raises saved instead of raised."""
    from floodseg_tpu_torch.parallel import current_world, maybe_initialize_multihost
    t0 = time.perf_counter()
    if backend == "gloo":
        torch.cuda.set_device(0)
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://{os.environ['FLOODSEG_COORDINATOR']}",
            world_size=int(os.environ["FLOODSEG_NUM_PROCESSES"]),
            rank=int(os.environ["FLOODSEG_PROCESS_ID"]))
    maybe_initialize_multihost()
    world = current_world()
    dev = torch.device("cuda", torch.cuda.current_device())
    log(f"[23 rank {world.rank}/{world.size}] {part} on {dev} "
        f"({torch.distributed.get_backend()}), up in {time.perf_counter() - t0:.1f} s")
    for p in part.split(","):
        pre = os.path.join(os.path.dirname(prefix), p)
        if p == "nccl_probe":
            try:
                x = torch.ones(1, device=dev)
                torch.distributed.all_reduce(x)
                torch.cuda.synchronize(dev)
                result = {"error": None, "value": float(x)}
            except RuntimeError as e:  # DistBackendError among them
                result = {"error": f"{type(e).__name__}: {e}"}
        else:
            build.build(["warp", "resize"])
            if p == "fit":
                result = ddp_fit(dev, os.path.join(DATA_DIR, "train_tree"), world,
                                 2 // world.size)
            elif p.startswith("u2pl"):
                result = ddp_u2pl(dev, world, p.partition("-")[2] or None)
            else:
                result = ddp_predict(dev, world, f"{pre}.rank{world.rank}.out")
        torch.save(result, f"{pre}.rank{world.rank}.pt")
        del result
        torch.cuda.empty_cache()
        log(f"[23 rank {world.rank}/{world.size}] {p} done at {time.perf_counter() - t0:.1f} s")
    if part != "nccl_probe":  # its communicator is broken
        torch.distributed.destroy_process_group()
    return 0


def change_within(name, got, ref, p0, floor=None) -> float:
    """4t's rule on what a step changed: per tensor that ``ref``'s step
    moved, max|got - ref| / max|ref - p0| within STEP_FLOOR_FACTOR times
    ``floor`` (the tensor's float32 floor, the same measure between two
    one-rank runs), never tighter than STEP_ABS. Returns the largest
    distance over its limit; raises above 1."""
    e = step_rel(got, ref, p0)
    floor = floor or {}
    limit = {k: max(STEP_ABS, STEP_FLOOR_FACTOR * floor.get(k, 0.0)) for k in e}
    worst = sorted(e, key=lambda k: e[k] / limit[k], reverse=True)[:3]
    moved = {k for k in ref if not torch.equal(ref[k], p0[k])}
    moved_got = {k for k in got if not torch.equal(got[k], p0[k])}
    bits = sum(not torch.equal(got[k], ref[k]) for k in ref)
    ratio = max(e[k] / limit[k] for k in e)
    log(f"  {name}: {len(e)} tensors moved, {bits} differ bitwise; the change's distance "
        f"median {statistics.median(e.values()):.2e}, largest over its limit {ratio:.3f} "
        f"({'; '.join(f'{k} {e[k]:.2e} of limit {limit[k]:.2e}' for k in worst)})")
    if ratio > 1.0 or moved != moved_got:
        raise AssertionError(f"phase {name}: a step's change outside 4t's rule "
                             f"({ratio:.3f} of the limit; moved sets equal: "
                             f"{moved == moved_got})")
    return ratio


def _rank_line(part, results) -> None:
    """Each rank's seconds (and ms a step), peak memory and launches (by
    decoder for DP predict)."""
    for r, res in enumerate(results):
        runs = [("", res)] if "launches" in res else list(res.items())
        for name, v in runs:
            steps = f", ms a step {v['step_ms']}" if "step_ms" in v else ""
            log(f"  {part}{' ' + name if name else ''} rank {r}: {v['seconds']:.2f} s{steps}, "
                f"peak {v['peak_gb']:.2f} GB, launches "
                f"{ {k: v['launches'][k] for k in DDP_KERNELS} }")


def ddp_u2pl_part(dev, u2) -> None:
    """Phase 23b's contrastive check: the semi step over 2 gloo ranks (``u2``,
    their results) against one rank (``u2pl_readings`` within their
    limits)."""
    log(f"  contrastive: sup step, sync, semi step of PSPNet-50 (aux, rep), batch 2 + 2 at "
        f"{DDP_U2PL_CROP} px, num_devices 2, 2 gloo ranks against one rank")
    _rank_line("u2pl (gloo, 2 ranks)", u2)
    one_u2 = ddp_u2pl(dev, None)
    torch.cuda.empty_cache()
    log(f"  losses 2 ranks {u2[0]['losses']}, 1 rank {one_u2['losses']}; bank counts "
        f"{u2[0]['bank_counts'].tolist()} and {one_u2['bank_counts'].tolist()}; one rank "
        f"{one_u2['seconds']:.2f} s, peak {one_u2['peak_gb']:.2f} GB")
    readings = u2pl_readings(u2, one_u2)
    failed = u2pl_failures(readings)
    log(f"  2 ranks against 1: {u2pl_line(readings)}")
    if failed:
        raise AssertionError(f"phase 23b contrastive: {failed} over their limits")
    del u2, one_u2


def ddp_predict_part(dev, dp) -> dict:
    """Phase 23c: run_flow_predict over 2 gloo ranks (``dp``, their
    results) against one rank. Returns the ranks' launches, summed."""
    log(f"[23c] DP predict through run_flow_predict(no_cropping, world): PSPNet-50 bf16, "
        f"{SIZE} px, n = {FRAME_DELTA}, {DDP_WINDOWS} windows (a batch of one a rank, then a "
        f"ragged batch of one), the bf16 and the int8 decoder, 2 gloo ranks against one rank")
    _rank_line("predict (gloo, 2 ranks)", dp)
    ref_dir = os.path.join(DDP_DIR, "predict.one.out")
    plain_dir = os.path.join(DDP_DIR, "predict.plain.out")
    for d in (ref_dir, plain_dir):
        shutil.rmtree(d, ignore_errors=True)
    one_c = ddp_predict(dev, None, ref_dir)
    one_p = ddp_predict(dev, None, plain_dir, plain=True)
    torch.cuda.empty_cache()
    frames = DDP_WINDOWS * FRAME_DELTA

    def png_maps(d):
        names = sorted(os.listdir(d), key=lambda n: int(n.split(".")[0]))
        return names, torch.stack([torch.from_numpy(imread(os.path.join(d, n)))
                                   for n in names]).to(torch.uint8)

    def same_bytes(a, b):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            return fa.read() == fb.read()

    predict_launches = {k: 0 for k in DDP_KERNELS}
    cached_off = []
    for dec in ("bf16", "int8"):
        plain, cached = one_p[dec], one_c[dec]
        names, ref_maps = png_maps(os.path.join(plain_dir, dec, "png"))
        c_names, c_maps = png_maps(os.path.join(ref_dir, dec, "png"))
        if tuple(ref_maps.shape) != (frames, SIZE, SIZE) or c_names != names:
            raise AssertionError(f"phase 23c {dec}: one rank wrote maps "
                                 f"{tuple(ref_maps.shape)} and {tuple(c_maps.shape)}")
        for r, res in enumerate(dp):
            got = res[dec]
            maps = torch.cat(got["maps"])
            unequal = (int((maps != ref_maps).sum()) if maps.shape == ref_maps.shape
                       else -1)
            wrote = os.path.exists(os.path.join(DDP_DIR, f"predict.rank{r}.out"))
            per = got["launches"]
            # rank r: its window of the full batch, then the ragged window
            want_k = {"grid_sample_cuda": 3 * 2, "warp_chain_cuda": 2 * 2,
                      "resize_quantize_int8_cuda": 2 if dec == "int8" else 0}
            log(f"  {dec} rank {r}: {len(got['maps'])} batches of maps "
                f"{[tuple(m.shape) for m in got['maps']]}, {unequal} pixels differ from one "
                f"rank's non-cached maps and {int((maps != c_maps).sum())} from "
                f"run_flow_predict's; summary equal to the non-cached one rank's: "
                f"{got['summary'] == plain['summary']}; wrote files: {wrote}; "
                f"{got['frames_per_second']:.2f} frames/s; launches "
                f"{ {k: per[k] for k in want_k} } (expected {want_k})")
            if unequal or len(got["maps"]) != 2 or got["summary"] != plain["summary"]:
                raise AssertionError(f"phase 23c {dec} rank {r}: {unequal} pixels differ, "
                                     f"summary {got['summary']} against {plain['summary']}")
            if {k: per[k] for k in want_k} != want_k:
                raise AssertionError(f"phase 23c {dec} rank {r}: launches {per}")
            if wrote != (r == 0):
                raise AssertionError(f"phase 23c {dec}: rank {r} wrote files: {wrote}")
            for k in DDP_KERNELS:
                predict_launches[k] += per[k]
        # rank 0 wrote what one rank writes on the same route, byte for byte
        ours = os.path.join(DDP_DIR, "predict.rank0.out", dec)
        same_pngs = sorted(os.listdir(os.path.join(ours, "png"))) == sorted(names) and all(
            same_bytes(os.path.join(ours, "png", n), os.path.join(plain_dir, dec, "png", n))
            for n in names)
        same_avi = same_bytes(ours + ".avi", os.path.join(plain_dir, f"{dec}.avi"))
        log(f"  {dec}: rank 0's PNGs equal one rank's, byte for byte: {same_pngs}; its AVI "
            f"({len(read_mjpg_avi(ours + '.avi'))} frames): {same_avi}")
        if not (same_pngs and same_avi):
            raise AssertionError(f"phase 23c {dec}: rank 0's files differ from one rank's")
        # run_flow_predict on one device reuses the next key's encoding (the
        # cached pair), which the ranks do not: its first window runs the
        # same program, bit for bit; later ones reuse an encoding made alone
        # where the ranks make it beside the previous key, the same function
        # with a bf16 rounding elsewhere, held by 5p's rule for that (at
        # least COMPOSED_MIN_EQUAL of the pixels equal)
        moved = [int((c_maps[w:w + FRAME_DELTA] != ref_maps[w:w + FRAME_DELTA]).sum())
                 for w in range(0, frames, FRAME_DELTA)]
        equal = 1.0 - sum(moved) / ref_maps.numel()
        log(f"  {dec} one rank: run_flow_predict (cached route) {cached['seconds']:.2f} s "
            f"with the loader, {cached['frames_per_second']:.2f} frames/s, peak "
            f"{cached['peak_gb']:.2f} GB; the non-cached route {plain['seconds']:.2f} s, "
            f"{plain['frames_per_second']:.2f} frames/s; pixels that differ between the two "
            f"by window {moved} (the first: 0 required), {equal:.6f} equal (at least "
            f"{COMPOSED_MIN_EQUAL:g}); summary "
            f"{ {k: v for k, v in cached['summary'].items() if not k.endswith('classes')} }")
        if moved[0] or equal < COMPOSED_MIN_EQUAL or (
                cached["summary"]["frames"] != plain["summary"]["frames"]):
            cached_off.append(f"{dec}: {moved} pixels by window")
    if cached_off:
        raise AssertionError(f"phase 23c: the cached and non-cached one-rank routes differ "
                             f"({'; '.join(cached_off)})")
    return predict_launches


def ddp_phase(dev, root) -> dict:
    """Phase 23: data parallelism on the card (parallel/, the global-batch
    steps). Returns the launches of the main path's runs, summed over the
    ranks, by part."""
    smi = nvidia_smi_line()
    t_all = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    p0 = {k: v.detach().clone() for k, v in random_model(
        "pspnet", torch.float32, seed=7, image_size=CROP, with_aux=True).state_dict().items()}
    log(f"[23a] one rank over NCCL: run_flow_fit, PSPNet-50 float32, global batch 2, "
        f"{CROP} px crops, {DDP_STEPS} steps, {DDP_VAL} validation frames, on {smi}")
    t0 = time.perf_counter()
    # 23b's NCCL probe starts beside it: its two ranks fail at their first
    # all-reduce, within the one rank's start-up
    with ThreadPoolExecutor(1) as pool:
        probe = pool.submit(launch_ranks, "nccl_probe", 2, "nccl", 120, expect_fail=True)
        (one,) = launch_ranks("fit", 1, "nccl", 600)
        log(f"  wall {time.perf_counter() - t0:.1f} s with the process start (23b's NCCL probe "
            f"beside it)")
        codes, outs = probe.result()
    _rank_line("fit (NCCL, 1 rank)", [one])
    warps = 2 * (FRAME_DELTA - 1)
    want = {"grid_sample_cuda": warps * (DDP_STEPS + DDP_VAL),
            "grid_sample_backward_cuda": warps * DDP_STEPS}
    got = {k: one["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"phase 23a launched {got}, phase 14's step launches {want}")
    log("  phase 14's step in this process (no process group), the reference, and the same "
        "with the batch's samples reversed (the float32 floor of reordering its sums):")
    ref = ddp_fit(dev, root, None, 2)
    rev = ddp_fit(dev, root, None, 2, reverse=True)
    torch.cuda.empty_cache()
    floor = step_rel(rev["state"], ref["state"], p0)
    log(f"  one device: {ref['seconds']:.2f} s, ms a step {ref['step_ms']} (reversed "
        f"{rev['step_ms']}), peak {ref['peak_gb']:.2f} GB, record "
        f"{ref['record']}; reversed: record {rev['record']}; one rank over NCCL: record "
        f"{one['record']}; the floor's median {statistics.median(floor.values()):.2e}, "
        f"largest {max(floor.values()):.2e} of a tensor's largest change")
    del rev
    change_within("23a against phase 14's step", one["state"], ref["state"], p0, floor)
    del one["state"]

    log("[23b] two ranks on the one card")
    msgs = [next((ln for ln in out.splitlines() if "Duplicate GPU" in ln), None)
            for out in outs]
    for r, (c, out) in enumerate(zip(codes, outs)):
        res = (torch.load(os.path.join(DDP_DIR, f"nccl_probe.rank{r}.pt"), weights_only=False)
               if c == 0 else {"error": "the rank did not finish"})
        log(f"  NCCL, two ranks on cuda:0, one all-reduce: rank {r} exit {c}; "
            f"{(res.get('error') or 'no error')[:300]}")
    log(f"  NCCL refuses two ranks on one device: "
        f"{'yes (Duplicate GPU detected)' if any(msgs) else 'see the lines above'}. The two "
        f"ranks run on gloo with CUDA tensors.")
    t0 = time.perf_counter()
    ddp_predict_tree()  # 23c's, which the launch below reads
    for r in range(2):
        shutil.rmtree(os.path.join(DDP_DIR, f"predict.rank{r}.out"), ignore_errors=True)
    log(f"  23c's tree: {DDP_WINDOWS * FRAME_DELTA + 1} frames of 512x512 written in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launched = launch_ranks("fit,u2pl,predict", 2, "gloo", 900)
    log(f"  the fit (1 + 1 samples), 23b's contrastive steps and 23c's DP predict over 2 gloo "
        f"ranks, one launch: wall {time.perf_counter() - t0:.1f} s")
    two = launched["fit"]
    _rank_line("fit (gloo, 2 ranks)", two)
    # each rank: every step's forward on its sample, its share of the
    # validation frames
    want_rank = {"grid_sample_cuda": warps * (DDP_STEPS + DDP_VAL // 2),
                 "grid_sample_backward_cuda": warps * DDP_STEPS}
    for r, res in enumerate(two):
        got = {k: res["launches"][k] for k in want_rank}
        if got != want_rank:
            raise AssertionError(f"phase 23b rank {r} launched {got}, expected {want_rank}")
    differ = sum(not torch.equal(two[0]["state"][k], two[1]["state"][k]) for k in p0)
    log(f"  the two ranks' states: {differ} tensors differ (0 required); records "
        f"{[r['record'] for r in two]}")
    if differ:
        raise AssertionError(f"phase 23b: the ranks' states differ in {differ} tensors")
    change_within("23b (2 ranks) against 23a (1 rank)", two[0]["state"], ref["state"], p0,
                  floor)
    d_loss = abs(two[0]["record"]["train_loss"] - ref["record"]["train_loss"])
    log(f"  train loss 2 ranks {two[0]['record']['train_loss']:.7f}, 1 rank "
        f"{ref['record']['train_loss']:.7f} (rel {d_loss / abs(ref['record']['train_loss']):.2e},"
        f" tol 1e-4); val mIoU {two[0]['record']['val_miou']:.6f} and "
        f"{ref['record']['val_miou']:.6f}")
    if d_loss > 1e-4 * abs(ref["record"]["train_loss"]):
        raise AssertionError("phase 23b: the train loss differs from the one-rank run's")
    fit_launches = {k: sum(r["launches"][k] for r in two) for k in DDP_KERNELS}
    for r in two:
        del r["state"]
    del ref

    ddp_u2pl_part(dev, launched["u2pl"])
    predict_launches = ddp_predict_part(dev, launched["predict"])
    log(f"  phase 23: {time.perf_counter() - t_all:.1f} s on {smi}")
    return {"pspnet_f32_ddp_fit": {"launches": fit_launches},
            "pspnet_bf16_ddp_predict": {"launches": predict_launches}}


def ddp_alone() -> int:
    """--ddp: build warp.cu, resize.cu and the codec, write phase 14's tree,
    then phase 23."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "resize", "jpeg"])
    ddp_phase(torch.device("cuda"), train_tree())
    return 0


def ddp_faults_alone() -> int:
    """--ddp-faults: the readings of phase 23b's contrastive check on a
    second one-rank run and a sound 2-rank run (both must pass every
    limit) and on 2 ranks under each planted fault (each must fail one),
    against one one-rank run. The readings also go to
    build/ddp/faults.json. Exits 1 when a sound run fails or a fault
    passes."""
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"[1] environment: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")
    build_kernels(["warp", "resize"])
    log(f"[23f] the contrastive check of 23b against planted faults, on {smi}")
    one = ddp_u2pl(dev, None)
    rows = {"one rank, again": u2pl_readings([ddp_u2pl(dev, None)] * 2, one)}
    torch.cuda.empty_cache()
    for fault in (None,) + DDP_FAULTS:
        two = launch_ranks("u2pl" if fault is None else f"u2pl-{fault}", 2, "gloo", 600)
        rows[f"2 ranks, {fault or 'sound'}"] = u2pl_readings(two, one)
    bad = []
    for name, r in rows.items():
        failed = u2pl_failures(r)
        log(f"  {name}: {u2pl_line(r)}; over its limit: {failed or 'none'}")
        if bool(failed) != (name.split(", ")[-1] in DDP_FAULTS):
            bad.append(name)
    with open(os.path.join(DDP_DIR, "faults.json"), "w") as f:
        json.dump(rows, f, indent=1)
    log(f"  sound runs that fail a limit or faults that pass every one: {bad or 'none'}")
    return 1 if bad else 0


# ----------------------------------------- the opt-ins: phases 24 and 25

# 24a: the flow-predict slice with the int8 encoder, card against CPU
# (float32 models, TF32 off, 129 px key frames, n = 5). The int8 sums are
# exact on both, but the card's rsqrt in the BN fold and its float32
# orders (the stem's convolution, the dequantization's rounding) put a few
# values on the other side of a quantization boundary, and a per-tensor
# scale that moves re-rounds a whole map; through 16 blocks the cases
# compound (on the CPU against the JAX package at 49 px the encodings'
# mean gap reads 2.0e-4 to 2.1e-3 of their largest magnitude, the largest
# 8.0e-3 to 4.5e-2: tests/test_torch_int8_trunk.py). Held as the CPU
# tests hold JAX: the encodings' and the logits' mean and largest gaps as
# shares of their largest magnitude, and the share of map pixels equal.
# Read on an H100 80GB HBM3 at 700 W: the means 1.3e-3 to 3.8e-3, the
# largest 1.4e-2 to 3.7e-2, the maps 0.9798 (DeepLabV3) to 0.99999 equal,
# 34-37% of the int8 lanes off by up to 8 steps after the cascade.
INT8_ENC_SLICE = 129
INT8_ENC_GAP = {"mean": 1e-2, "largest": 0.2}
INT8_ENC_MAPS = 0.95
INT8_ENC_CASES = (("pspnet", False), ("pspnet", True), ("deeplabv3", False))


def gap_shares(got, ref) -> tuple:
    """(mean, largest) of |got - ref| as shares of max|ref|."""
    scale = float(ref.abs().max())
    d = (got.float() - ref.float()).abs()
    return float(d.mean()) / scale, float(d.max()) / scale


def check_int8_encoder_card_vs_cpu(arch, int8_decode, n=5, size=INT8_ENC_SLICE,
                                   seed=1) -> dict:
    """Phase 24a: the slice of ``arch`` (float32, TF32 off) with the int8
    encoder and the full-precision or int8 decoder, on the CPU with every
    conv_int8 call recorded, then on the card: each recorded call replayed
    on the card from the CPU's int8 input and weights gives the CPU's int32
    accumulator (the trunk's 1x1s, its 3x3s at stride 2 and at dilations 2
    and 4, the strided downsamples; the decoder's with int8_decode); the
    int8 maps' share of lanes off and largest step logged; the logits and
    the two windows' next-key encodings within INT8_ENC_GAP, the maps
    equal on at least INT8_ENC_MAPS of the pixels."""
    cpu_model = random_model(arch, torch.float32, seed, image_size=size)
    gpu_model = copy.deepcopy(cpu_model)
    wins = clip_windows(n, SLICE_FRAME_HW, 2, size, "cpu", seed)
    with full_precision_f32():
        t0 = time.perf_counter()
        with Int8Calls() as ref_calls:
            ref = slice_outputs(cpu_model, torch.device("cpu"), n, size, SLICE_FRAME_HW, wins,
                                int8_decode, int8_encode=True)
        t1 = time.perf_counter()
        with Int8Calls() as got_calls:
            got = slice_outputs(gpu_model, torch.device("cuda"), n, size, SLICE_FRAME_HW, wins,
                                int8_decode, int8_encode=True)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    kinds, unequal = set(), 0
    for x_q, w_q, padding, dilation, strides, acc in ref_calls.calls:
        card = quant.conv_int8(x_q.cuda(), w_q.cuda(), padding, dilation, strides).cpu()
        unequal += int(not torch.equal(card, acc))
        kinds.add((w_q.shape[-1], strides, dilation))
    lanes = [lanes_off(a, b) for (a, *_), (b, *_) in zip(got_calls.calls, ref_calls.calls)]
    share = max(v[0] for v in lanes)
    step = max(v[1] for v in lanes)
    log(f"  {arch}, {'int8' if int8_decode else 'float32'} decoder: cpu {t1 - t0:.1f} s, card "
        f"{t2 - t1:.1f} s; {len(ref_calls.calls)} int8 convs ({len(got_calls.calls)} on the "
        f"card) replayed on the card from the CPU's operands: {unequal} accumulators differ; "
        f"kinds (k, stride, dilation) {sorted(kinds)}; int8 maps card vs CPU: the largest "
        f"share of lanes off {share:.2e}, the largest step {step}")
    if unequal or len(got_calls.calls) != len(ref_calls.calls):
        raise AssertionError("int32 accumulators differ between card and CPU")
    wanted = {(3, (2, 2), (1, 1)), (1, (2, 2), (1, 1)), (3, (1, 1), (2, 2)),
              (3, (1, 1), (4, 4))}
    if not wanted <= kinds:
        raise AssertionError(f"the trunk's convs lack {wanted - kinds}")
    readings = {}
    for k in ("logits", "enc0", "enc1"):
        mean, largest = readings[k] = gap_shares(got[k], ref[k])
        log(f"  {k} {tuple(ref[k].shape)}: gap mean {mean:.2e}, largest {largest:.2e} of "
            f"max {float(ref[k].abs().max()):.3e} (limits {INT8_ENC_GAP['mean']:g}, "
            f"{INT8_ENC_GAP['largest']:g})")
        if mean > INT8_ENC_GAP["mean"] or largest > INT8_ENC_GAP["largest"]:
            raise AssertionError(f"phase 24a: card and CPU {k} disagree")
    for k in ("maps0", "maps1"):
        same = readings[k] = float((got[k] == ref[k]).float().mean())
        log(f"  {k}: {same:.6f} of the pixels equal (limit {INT8_ENC_MAPS})")
        if same < INT8_ENC_MAPS:
            raise AssertionError(f"phase 24a: card and CPU {k} agree on only {same:.6f}")
    return {"lanes_share": share, "lanes_step": step, **readings}


def int8_trunk_split(model, frame, reps=3) -> dict:
    """Phase 24b's trunk split: ``reps`` int8 encoder calls on one key frame
    (after a warm-up) under torch.profiler, each im2col, torch._int_mm and
    activation quantization in a record_function range of its own; ms a
    call of the kernels in each range (im2col, _int_mm, quantize), of the
    whole call (the union of its kernels) and of the rest (the stem's
    convolutions, the BN folds and weight quantization, the
    dequantization epilogues, the residual adds, the max pool, PSPNet's
    PPM, the casts)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    enc = _predict_encode(model, True)
    dev = torch.device("cuda")
    x = ((frame.float() - torch.tensor(MEAN, device=dev)) / torch.tensor(STD, device=dev))
    pieces = {"im2col": (quant, "im2col_nhwc"), "_int_mm": (torch, "_int_mm"),
              "quantize": (quant, "quantize_activation_dynamic")}
    originals = {name: getattr(owner, attr) for name, (owner, attr) in pieces.items()}

    def ranged(name):
        fn = originals[name]

        def call(*a, **k):
            with torch.profiler.record_function(f"int8 trunk: {name}"):
                return fn(*a, **k)
        return call

    for name, (owner, attr) in pieces.items():
        setattr(owner, attr, ranged(name))
    try:
        with torch.inference_mode(), full_precision_f32():
            enc(x)
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    enc(x)
                torch.cuda.synchronize()
    finally:
        for name, (owner, attr) in pieces.items():
            setattr(owner, attr, originals[name])
    os.makedirs(PROFILE_DIR, exist_ok=True)
    trace = os.path.join(PROFILE_DIR, "int8_trunk_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel")
    ranges = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "gpu_user_annotation"
                     and e["name"] == f"int8 trunk: {name}"] for name in pieces}
    out = {"call_ms": union_us(kernels) / (1e3 * reps), "kernels": len(kernels) / reps}
    for name, spans in ranges.items():
        inside = [k for k in kernels if any(a <= k[0] < b for a, b in spans)]
        out[f"{name}_ms"] = union_us(inside) / (1e3 * reps)
    out["rest_ms"] = out["call_ms"] - sum(out[f"{n}_ms"] for n in pieces)
    if not all(ranges.values()):
        raise AssertionError(f"the trunk profile saw no range for "
                             f"{[n for n, v in ranges.items() if not v]}")
    return out


def int8_encoder_phases(dev) -> dict:
    """Phases 24a-c (see the module note); returns the main paths by tag."""
    log(f"[24a] the slice with the int8 encoder on the card against the CPU (float32, "
        f"{INT8_ENC_SLICE} px key frames, n = 5)")
    t0 = time.perf_counter()
    slices = {f"{a}_{'int8' if d else 'f32'}_decoder": check_int8_encoder_card_vs_cpu(a, d)
              for a, d in INT8_ENC_CASES}
    log(f"  phase 24a: {time.perf_counter() - t0:.1f} s")
    paths = {}
    for arch, size, name in (("pspnet", SIZE, "PSPNet-50"), ("deeplabv3", DL_SIZE,
                                                             "DeepLabV3-50")):
        model = random_model(arch, torch.bfloat16, seed=0)
        wins = clip_windows(FRAME_DELTA, (512, 512), CLIPS_TIMED + 2, size, dev)
        for int8 in (False, True):
            tag = f"{arch}_int8enc_{'int8' if int8 else 'bf16'}"
            log(f"[24b] the int8 encoder's main path: {name} bf16, {size} px key frames, n = "
                f"{FRAME_DELTA}, {'int8' if int8 else 'bf16'} decoder (bench.py --int8-enc)")
            r = paths[tag] = run_main_path(model, wins, int8, tag, size=size, int8_encode=True)
            log(f"  {r['fps']:.2f} frames/s (median of {PASSES} passes x {CLIPS_TIMED} "
                f"windows; passes {[round(f, 2) for f in r['fps_passes']]}), peak memory "
                f"{r['peak_gb']:.2f} GB on {nvidia_smi_line()}")
            # 24c: the same window through the full-precision encoder, for the record
            w = wins[CLIPS_TIMED]
            maps = {}
            for enc in (False, True):
                fn = make_flow_predict_fn(model, n=FRAME_DELTA, out_size=(size, size),
                                          default_grid=default_grid(512, 512),
                                          int8_decode=int8, int8_encode=enc, device=dev)
                maps[enc] = fn(model.state_dict(), w["frame_prev"], w["frame_next"],
                               w["mvs_left"], w["mvs_right"])
            r["agree_bf16_encoder"] = float((maps[True] == maps[False]).float().mean())
            log(f"  [24c] the int8 encoder's maps equal the bf16 encoder's on "
                f"{r['agree_bf16_encoder']:.4f} of the pixels of one window (a reading: "
                f"random weights, no limit)")
        split = paths[f"{arch}_int8enc_bf16"]["trunk"] = int8_trunk_split(
            model, wins[1]["frame_next"])
        log(f"  the int8 encoder call by the profiler (ms a call, 3 calls): "
            f"{ {k: round(v, 4) for k, v in split.items()} }")
        model.cpu()
        del wins
        torch.cuda.empty_cache()
    log(f"  phase 24a readings: {json.dumps(slices)}")
    return paths


def remat_flow_fit(dev, root, remat, reverse=False) -> dict:
    """Phase 25a's fit: run_flow_fit of phase 14's PSPNet-50 (float32, aux
    head, seed 7) with every bottleneck rematerialised or not, 433 px
    crops, batch 2, DDP_STEPS steps, one validation frame; ``reverse``:
    under ``reversed_samples``. Returns the state (on the host), the first
    one (p0), each step's synchronised ms, the launches and the peak
    memory."""
    model = random_model("pspnet", torch.float32, seed=7, image_size=CROP, with_aux=True,
                         remat=remat)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = default_fit_config(train_h=CROP, train_w=CROP, resize_h=FRAME_HW[0],
                             resize_w=FRAME_HW[1], frame_delta=FRAME_DELTA, max_epochs=1,
                             limit_train_batches=DDP_STEPS, limit_val_batches=1)
    prof = PhaseProfiler(sync=lambda: torch.cuda.synchronize(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    with reversed_samples(model) if reverse else contextlib.nullcontext():
        run_flow_fit(model, root, cfg, profiler=prof, device=dev)
    torch.cuda.synchronize(dev)
    return {"state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "p0": p0, "step_ms": [round(1e3 * s, 1) for s in prof.recorded_durations[
                "train_step"]], "launches": launch_counts(),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def remat_phases(dev, root) -> dict:
    """Phase 25 (see the module note); returns the U2PL run by tag."""
    log("[25a] phase 14's flow step with remat against the same step without it "
        "(PSPNet-50 float32 with aux head, 433 px crops, batch 2, 2 steps), the floor from "
        "the plain steps on the batch reversed (23a's)")
    t0 = time.perf_counter()
    runs = {name: remat_flow_fit(dev, root, r, rev) for name, r, rev in (
        ("plain", False, False), ("remat", True, False), ("plain, reversed", False, True))}
    for name, v in runs.items():
        log(f"  {name}: ms a step {v['step_ms']}, peak {v['peak_gb']:.2f} GB, launches "
            f"{v['launches']}")
    plain, remat = runs["plain"], runs["remat"]
    if remat["launches"] != plain["launches"] or not plain["launches"]["grid_sample_cuda"]:
        raise AssertionError(f"phase 25a's launches differ: {remat['launches']}, "
                             f"{plain['launches']}")
    p0 = plain["p0"]
    floor = step_rel(runs["plain, reversed"]["state"], plain["state"], p0)
    stats = [k for k in plain["state"] if "running" in k]
    change_within("25a remat flow step, every tensor", remat["state"], plain["state"], p0,
                  floor)
    change_within("25a remat flow step, the BN running statistics",
                  {k: remat["state"][k] for k in stats}, {k: plain["state"][k] for k in stats},
                  {k: p0[k] for k in stats}, floor)
    log(f"  phase 25a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tag = "pspnet101_f32_contrastive_remat"
    log("[25b] phase 21's contrastive run with remat (PSPNet-101 float32 with aux and rep "
        "heads, 873 px crops, batch 2 + 2)")
    result = u2pl_phase(dev, root, tag, remat=True)
    log(f"  phase 25b: a semi step {result['step_ms']:.1f} ms, peak {result['peak_gb']:.2f} GB "
        f"(phase 21 without remat, PR 15's run: 1563.4 ms, 63.98 GB) on {nvidia_smi_line()}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"pspnet_f32_remat_flow": {"launches": remat["launches"],
                                      "step_ms": statistics.median(remat["step_ms"]),
                                      "peak_gb": remat["peak_gb"],
                                      "plain_step_ms": statistics.median(plain["step_ms"]),
                                      "plain_peak_gb": plain["peak_gb"]},
            tag: result}


def int8_enc_alone() -> int:
    """--int8-enc: build warp.cu and resize.cu, then phase 24."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "resize"])
    int8_encoder_phases(torch.device("cuda"))
    return 0


def remat_alone() -> int:
    """--remat: build warp.cu and the codec, write phase 14's tree, then
    phase 25."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "jpeg"])
    remat_phases(torch.device("cuda"), train_tree())
    return 0


# ------------------------------------------- the Segmenter stack: phase 26

SEGM_DIR = os.path.join(os.path.dirname(DATA_DIR), "segm")
SEGM_TRAIN_HW, SEGM_VAL_HW = (512, 683), (448, 640)  # ADE20K's usual 4:3-ish frames
SEGM_ARGS = ["--im-size", "512", "--crop-size", "512", "--batch-size", "8", "--window-size",
             "512", "--window-stride", "480", "--workers", "8"]
SEGM_NARROW = ["--im-size", "64", "--patch-size", "32", "--d-model", "128", "--n-layers", "2",
               "--dec-layers", "1", "--batch-size", "2", "--epochs", "1", "--eval-freq", "2",
               "--workers", "2"]
# 26b's bounds, the card (float32, TF32 off) against the CPU: the step's
# loss, rtol; its change by 4t's rule (STEP_ABS); the sliding window's
# probabilities, atol, and the share of pixels whose argmax must agree;
# each attention layer's probabilities, atol; the classifier's logits, a
# share of their largest magnitude (tests/test_torch_vit.py's NET_SHARE)
SEGM_LOSS_RTOL = 1e-4
SEGM_PROB_ATOL = 1e-4
SEGM_ARGMAX_SHARE = 0.999
SEGM_ATTN_ATOL = 1e-5
SEGM_LOGIT_SHARE = 1e-4


def segm_tree(root, n_train, n_val, hw, val_hw, seed=0) -> str:
    """An ADE20K-layout tree from the port's codec: images/{training,
    validation} JPEGs and annotations/... L PNGs of 8x8 blocks of labels
    0..150 (0 unlabeled), each block's pixels its class's colour plus
    noise, so the classes carry signal."""
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (151, 3))
    for split, n, (h, w) in (("training", n_train, hw), ("validation", n_val, val_hw)):
        for sub in ("images", "annotations"):
            os.makedirs(os.path.join(root, sub, split))
        for i in range(n):
            blocks = np.kron(rng.integers(0, 151, (8, 8)), np.ones((h // 8 + 1, w // 8 + 1)))
            lab = blocks[:h, :w].astype(np.uint8)
            im = np.clip(colours[lab] + rng.normal(0, 24, (h, w, 3)), 0, 255).astype(np.uint8)
            write_jpeg(os.path.join(root, "images", split, f"ade_{i:04d}.jpg"), im)
            write_png(os.path.join(root, "annotations", split, f"ade_{i:04d}.png"), lab)
    return root


@contextlib.contextmanager
def segm_timers(dev):
    """Inside: each train step of segm.train timed between synchronisations,
    each evaluation's seconds and images."""
    from floodseg_tpu_torch.segm import inference
    from floodseg_tpu_torch.train import supervised

    rec = {"step_ms": [], "eval_s": [], "eval_images": 0}
    own_step, own_eval = supervised.make_train_step, inference.evaluate_dataset

    def make_step(*args, **kwargs):
        step = own_step(*args, **kwargs)

        def timed(*step_args):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = step(*step_args)
            torch.cuda.synchronize(dev)
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    def evaluate(model, dataset, *args, **kwargs):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = own_eval(model, dataset, *args, **kwargs)
        torch.cuda.synchronize(dev)
        rec["eval_s"].append(time.perf_counter() - t0)
        rec["eval_images"] += len(dataset)
        return out

    supervised.make_train_step, inference.evaluate_dataset = make_step, evaluate
    try:
        yield rec
    finally:
        supervised.make_train_step, inference.evaluate_dataset = own_step, own_eval


def segm_log(log_dir) -> list:
    with open(os.path.join(log_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


def segm_step_alone(dev, root, amp) -> dict:
    """26a's step (ViT-B/32, 512 px, batch 8) on one batch held on the
    card with no loader running: ms a step (median of 5 after 2 warm-ups),
    and torch.profiler's device busy time and kernels a step over 2 more
    (the trace to build/profile/)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from floodseg_tpu_torch.models import SegmenterViT
    from floodseg_tpu_torch.segm.data import segm_dataset

    ds = segm_dataset("ade20k", root, "train", image_size=512, crop_size=512)
    batch = device_put(collate([ds.get(i, np.random.default_rng(i)) for i in range(8)]), dev)
    model = init_from_generator_(
        SegmenterViT(classes=150, image_size=512, dropout=0.0,
                     dtype=torch.bfloat16 if amp else torch.float32),
        torch.Generator().manual_seed(42)).to(dev)
    opt, schedule = make_optimizer(model, 1e-3, 100, weight_decay=0.0, head_lr_scale=1.0)
    state = TrainState(step=0, model=model, optimizer=opt, schedule=schedule)
    step = make_train_step(model, make_loss_fn("ce", aux_weight=0.0, ignore_index=255), 150)

    def run():
        nonlocal state
        state, m = step(state, batch, None)
        return float(m["loss"])

    times = []
    for _ in range(7):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    os.makedirs(PROFILE_DIR, exist_ok=True)
    trace = os.path.join(PROFILE_DIR, f"vit_b32_{'bf16' if amp else 'f32'}_segm_step_trace.json")
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        run()
        torch.cuda.synchronize(dev)
    prof.export_chrome_trace(trace)
    return {"step_ms": statistics.median(times[2:]), **device_time(trace, 2)}


def segm_train_phase(dev, root) -> dict:
    """26a: segm.train --dataset ade20k at full width (ViT-B/32, 512 px,
    batch 8, 150 classes): 2 epochs of 3 steps with their evaluations, a
    resume to a third, then 3 steps with --amp."""
    from floodseg_tpu_torch.segm import train as segm_train

    log_dir = os.path.join(SEGM_DIR, "vit_b32")
    amp_dir = os.path.join(SEGM_DIR, "vit_b32_amp")
    for d in (log_dir, amp_dir):
        shutil.rmtree(d, ignore_errors=True)
    base = ["--dataset", "ade20k", "--data-root", root] + SEGM_ARGS
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with segm_timers(dev) as rec:
        segm_train.main(["--log-dir", log_dir] + base + ["--epochs", "2"])
        segm_train.main(["--log-dir", log_dir] + base + ["--epochs", "3"])
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = launch_counts()
    entries = segm_log(log_dir)
    ckpts = sorted(os.listdir(os.path.join(log_dir, "checkpoints")))
    with open(os.path.join(log_dir, "checkpoints", "index.json")) as f:
        index = json.load(f)
    step = torch.load(os.path.join(log_dir, "checkpoints", "last-2.pt"), map_location="cpu",
                      weights_only=False)["step"]
    top = [n for n in ckpts if n.startswith("epoch=")]
    bad = []
    if [e["epoch"] for e in entries] != [0, 1, 2]:
        bad.append(f"log.txt epochs {[e['epoch'] for e in entries]}")
    if any(sorted(e) != ["epoch", "train_loss", "val_mean_acc", "val_mean_iou"]
           or not np.isfinite(e["train_loss"]) for e in entries):
        bad.append(f"log.txt entries {entries}")
    if (len(index) != 3 or sorted(f"{e['name']}.pt" for e in index) != top
            or not all("-val_miou=" in n for n in top)):
        bad.append(f"top-k index {index}, files {ckpts}")
    if step != 9 or "last" not in ckpts:
        bad.append(f"the resumed run ended at step {step} (9 expected), files {ckpts}")
    if any(launches.values()):
        bad.append(f"K1/K1-bwd/K2/K3 launched: {launches}")
    train_steps = len(rec["step_ms"])
    with segm_timers(dev) as amp_rec:
        segm_train.main(["--log-dir", amp_dir] + base + ["--epochs", "1", "--amp",
                                                         "--eval-freq", "2"])
    amp = segm_log(amp_dir)
    if len(amp) != 1 or not np.isfinite(amp[0]["train_loss"]) or "val_mean_iou" in amp[0]:
        bad.append(f"--amp log {amp}")
    if any(launch_counts().values()):
        bad.append(f"K1/K1-bwd/K2/K3 launched under --amp: {launch_counts()}")
    if bad:
        raise AssertionError("phase 26a: " + "; ".join(bad))
    step_ms = statistics.median(rec["step_ms"][1:])
    amp_ms = statistics.median(amp_rec["step_ms"][1:])
    eval_s = sum(rec["eval_s"]) / rec["eval_images"]
    log(f"  float32 (TF32 off): {train_steps} steps, {step_ms:.1f} ms a step (median after the "
        f"first; all {[round(t, 1) for t in rec['step_ms']]}), eval {eval_s:.3f} s an image "
        f"({rec['eval_images']} images, window 512, stride 480), peak {peak_gb:.2f} GB, "
        f"{seconds:.1f} s for both runs; losses {[round(e['train_loss'], 4) for e in entries]}, "
        f"val mIoU {[round(e['val_mean_iou'], 4) for e in entries]}; launches {launches}")
    log(f"  --amp (bf16 compute, float32 parameters): {amp_ms:.1f} ms a step (median after the "
        f"first; all {[round(t, 1) for t in amp_rec['step_ms']]}), loss "
        f"{amp[0]['train_loss']:.4f}; on {nvidia_smi_line()}")
    for name, amp_on in (("float32", False), ("--amp", True)):
        r = segm_step_alone(dev, root, amp_on)
        log(f"  the same step on one batch held on the card, no loader running, {name}: "
            f"{r['step_ms']:.1f} ms a step, device busy {r['busy_ms']:.1f} ms a step "
            f"(torch.profiler), {r['kernels']:.0f} kernels a step")
    return {"vit_b32_f32_segm_train": {"launches": launches, "step_ms": step_ms,
                                       "eval_s_an_image": eval_s, "peak_gb": peak_gb,
                                       "ckpt": os.path.join(log_dir, "checkpoints", "last")},
            "vit_b32_bf16_segm_amp": {"launches": launch_counts(), "step_ms": amp_ms}}


def segm_card_vs_cpu(dev) -> None:
    """26b: the narrow Segmenter (d 128, 2 + 1 layers, 64 px) through the
    same runs on the card and on the CPU: one segm.train step, the sliding
    window with flip, the attention maps; and a narrow ViTClassifier's
    logits."""
    from floodseg_tpu_torch.core.checkpoint import read_model_state
    from floodseg_tpu_torch.models import SegmenterViT, ViTClassifier
    from floodseg_tpu_torch.segm import attn, inference
    from floodseg_tpu_torch.segm import train as segm_train

    cpu = torch.device("cpu")
    root = segm_tree(os.path.join(SEGM_DIR, "ade_narrow"), 2, 1, (96, 128), (80, 112), seed=1)
    runs = {}
    for name, where in (("cpu", cpu), ("card", dev)):
        d = os.path.join(SEGM_DIR, f"narrow_{name}")
        shutil.rmtree(d, ignore_errors=True)
        segm_train.main(["--log-dir", d, "--dataset", "ade20k", "--data-root", root]
                        + SEGM_NARROW, device=str(where))
        state = read_model_state(os.path.join(d, "checkpoints", "last"))
        runs[name] = (segm_log(d)[0]["train_loss"], {k: v.cpu() for k, v in state.items()})
    cfg = dict(classes=150, image_size=64, patch_size=32, d_model=128, n_layers=2, dec_layers=1,
               dropout=0.0)
    p0 = segm_train.init_model(SegmenterViT(**cfg), 42).state_dict()
    (loss_cpu, s_cpu), (loss_card, s_card) = runs["cpu"], runs["card"]
    if abs(loss_card - loss_cpu) > SEGM_LOSS_RTOL * abs(loss_cpu):
        raise AssertionError(f"phase 26b: the step's loss {loss_card} on the card, {loss_cpu} "
                             f"on the CPU")
    log(f"  segm.train step: loss {loss_card:.6f} on the card, {loss_cpu:.6f} on the CPU "
        f"(rtol {abs(loss_card - loss_cpu) / abs(loss_cpu):.2e} of {SEGM_LOSS_RTOL})")
    change_within("26b segm.train step, card vs CPU", s_card, s_cpu, p0)

    models = {}
    for name, where in (("cpu", cpu), ("card", dev)):
        m = SegmenterViT(**cfg)
        m.load_state_dict(s_cpu)
        models[name] = m.to(where).eval()
    g = torch.Generator().manual_seed(5)
    im = torch.randn((96, 160, 3), generator=g)
    probs = {k: inference.sliding_inference(m, im.to(next(m.parameters()).device), 150, 64, 48,
                                            flip=True).cpu()
             for k, m in models.items()}
    gap = float((probs["card"] - probs["cpu"]).abs().max())
    agree = float((probs["card"].argmax(-1) == probs["cpu"].argmax(-1)).float().mean())
    log(f"  sliding_inference (96x160, window 64, stride 48, flip): probabilities within "
        f"{gap:.2e} (limit {SEGM_PROB_ATOL}), argmax equal on {agree:.5f} of pixels (at least "
        f"{SEGM_ARGMAX_SHARE})")
    if gap > SEGM_PROB_ATOL or agree < SEGM_ARGMAX_SHARE:
        raise AssertionError("phase 26b: sliding_inference card vs CPU outside its bounds")
    x = torch.randn((1, 64, 96, 3), generator=g)
    maps = {k: attn.attention_maps(m, x.to(next(m.parameters()).device))
            for k, m in models.items()}
    gaps = [float(np.abs(a - b).max()) for part in ("encoder", "decoder")
            for a, b in zip(maps["card"][part], maps["cpu"][part])]
    log(f"  attention_maps: {len(gaps)} layers, largest gap per layer "
        f"{[f'{v:.1e}' for v in gaps]} (limit {SEGM_ATTN_ATOL})")
    if len(gaps) != 3 or max(gaps) > SEGM_ATTN_ATOL:
        raise AssertionError("phase 26b: attention maps card vs CPU outside their bound")
    clf = init_from_generator_(ViTClassifier(n_cls=10, image_size=32, patch_size=16,
                                             d_model=128, n_layers=2),
                               torch.Generator().manual_seed(3)).eval()
    xc = torch.randn((4, 32, 32, 3), generator=g)
    with torch.no_grad(), full_precision_f32():
        ref = clf(xc)
        got = copy.deepcopy(clf).to(dev)(xc.to(dev)).cpu()
    share = float((got - ref).abs().max()) / float(ref.abs().max())
    log(f"  ViTClassifier (ViT/16 d 128, 32 px, 10 classes) logits within {share:.2e} of their "
        f"largest magnitude (limit {SEGM_LOGIT_SHARE})")
    if share > SEGM_LOGIT_SHARE:
        raise AssertionError("phase 26b: ViTClassifier logits card vs CPU outside their bound")


def segm_accuracy_phase(dev, classes=8, per_class=16) -> dict:
    """26c: cli/segm_accuracy.py, ViTClassifier ViT-B/16 at 224 px (1000
    classes, random weights) over a synthetic ImageFolder tree; the second
    pass timed."""
    from floodseg_tpu_torch.cli import segm_accuracy

    root = os.path.join(SEGM_DIR, "imagefolder")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(2)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"class_{c:03d}"))
        for i in range(per_class):
            h, w = (int(v) for v in rng.integers(240, 480, 2))
            write_jpeg(os.path.join(root, f"class_{c:03d}", f"{i:03d}.jpg"),
                       rng.integers(0, 256, (h, w, 3), np.uint8))
    argv = ["--data-dir", root, "--n-cls", "1000", "-bs", "32", "-nw", "8"]
    segm_accuracy.main(argv)
    reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    segm_accuracy.main(argv)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    n = classes * per_class
    launches = launch_counts()
    log(f"  {n} images in {seconds:.2f} s: {n / seconds:.1f} images/s end to end (JPEG decode, "
        f"bicubic resize, the model, batch 32, 8 loader threads), launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 26c: K1/K1-bwd/K2/K3 launched: {launches}")
    return {"vit_b16_f32_segm_accuracy": {"launches": launches, "images_per_s": n / seconds}}


def segm_export(dev) -> None:
    """26d's export: cli/export_ckpt.py writes a Lightning .ckpt of phase
    22's last checkpoint (with --segm alone, a fresh state of the same
    config saved first); the port's importer reads it back equal."""
    from floodseg_tpu_torch.cli import export_ckpt
    from floodseg_tpu_torch.cli.runner import Runner
    from floodseg_tpu_torch.core.checkpoint import read_model_state
    from floodseg_tpu_torch.core.config import load_config
    from floodseg_tpu_torch.models.torch_import import load_torch_file

    here = os.path.dirname(os.path.abspath(__file__))
    configs = [os.path.join(here, "configs", f"{n}.yaml") for n in CLI_CONFIGS]
    log_dir = os.path.join(os.path.dirname(DATA_DIR), "cli_logs")
    sets = [f"trainer.log_dir={log_dir}", "trainer.run_name=cli"]
    last = os.path.join(log_dir, "cli", "checkpoints", "last")
    if not os.path.exists(last):
        runner = Runner(load_config(configs, dict(kv.split("=") for kv in sets)))
        runner.ckpt.save(runner._fresh_state(), 0, {})
        log("  phase 22's run is absent (--segm alone): a fresh state of its config saved")
    out = os.path.join(SEGM_DIR, "exported.ckpt")
    export_ckpt.main([a for c in configs for a in ("--config", c)]
                     + [a for kv in sets for a in ("--set", kv)]
                     + ["--ckpt", last, "--out", out, "--epoch", "1"])
    back = load_torch_file(out)
    want = {k: v for k, v in read_model_state(last).items()
            if not k.startswith("aux.") and not k.endswith("num_batches_tracked")}
    got = {k: v for k, v in back["roles"]["model"].items()
           if not k.endswith("num_batches_tracked")}
    n_keys = len(torch.load(out, map_location="cpu", weights_only=False)["state_dict"])
    if (back["arch"], back["method_family"]) != ("pspnet", "flow_supervised") or \
            got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("phase 26d: the exported checkpoint does not read back equal")
    log(f"  export_ckpt: {n_keys} tensors (FlowPSPNet's layout with its aliases), read back "
        f"equal by import_lightning_checkpoint ({len(want)} tensors of the model but its aux "
        f"head)")


def segm_launchers_phase(dev, root, ckpt) -> None:
    """26d: segm_inference over the 4 validation images with their masks,
    show_attn_map (encoder, patch and class queries) on 26a's checkpoint,
    and the export."""
    from floodseg_tpu_torch.cli import segm_inference, show_attn_map
    from floodseg_tpu_torch.core.checkpoint import read_model_state

    out = os.path.join(SEGM_DIR, "inference")
    shutil.rmtree(out, ignore_errors=True)
    val = os.path.join(root, "images", "validation")
    reset_launch_counts()
    t0 = time.perf_counter()
    segm_inference.main(["--ckpt", ckpt, "-i", val, "-o", out, "--n-cls", "150",
                         "--image-size", "512", "--window-size", "512", "--window-stride", "480",
                         "--ann-dir", os.path.join(root, "annotations", "validation"),
                         "--reduce-zero-label"])
    seconds = time.perf_counter() - t0
    written = sorted(os.listdir(out))
    shapes = {imread(os.path.join(out, f)).shape for f in written}
    log(f"  segm_inference: {len(written)} overlays of shape {shapes} in {seconds:.2f} s")
    if len(written) != 4 or shapes != {SEGM_VAL_HW + (3,)}:
        raise AssertionError(f"phase 26d: segm_inference wrote {written}, shapes {shapes}")
    attn_dir = os.path.join(SEGM_DIR, "attn")
    shutil.rmtree(attn_dir, ignore_errors=True)
    image = os.path.join(val, sorted(os.listdir(val))[0])
    maps = []
    for query, extra in (("patch", []), ("cls", ["--cls"])):
        d = os.path.join(attn_dir, query)
        show_attn_map.main([ckpt, image, d, "--n-cls", "150", "--image-size", "512",
                            "--patch-size", "32", "--layer-id", "11"] + extra)
        maps += [os.path.join(d, f) for f in sorted(os.listdir(d))]
    shapes = {imread(f).shape for f in maps}
    log(f"  show_attn_map: {len(maps)} per-head maps of shape {shapes} (encoder layer 11, a "
        f"patch query and the class token's)")
    heads = read_model_state(ckpt)["encoder.cls_token"].shape[-1] // 64
    if len(maps) != 2 * heads or shapes != {(512, 512)}:
        raise AssertionError(f"phase 26d: show_attn_map wrote {maps}")
    if any(launch_counts().values()):
        raise AssertionError(f"phase 26d: K1/K1-bwd/K2/K3 launched: {launch_counts()}")
    segm_export(dev)


def segm_phases(dev) -> dict:
    """Phase 26 (see the module note); returns its paths' records."""
    t0 = time.perf_counter()
    root = segm_tree(os.path.join(SEGM_DIR, "ade"), 24, 4, SEGM_TRAIN_HW, SEGM_VAL_HW)
    log(f"[26a] segm.train --dataset ade20k: ViT-B/32 (d 768, 12 + 2 layers), 512 px crops, "
        f"batch 8, 150 classes, 2 epochs of 3 steps with their evaluations, a resume to a third, "
        f"then 3 steps with --amp (tree of 24 + 4 images written in "
        f"{time.perf_counter() - t0:.1f} s)")
    paths = segm_train_phase(dev, root)
    ckpt = paths["vit_b32_f32_segm_train"].pop("ckpt")
    log("[26b] the narrow Segmenter card vs CPU (float32, TF32 off): a segm.train step, "
        "sliding_inference, attention_maps, ViTClassifier")
    segm_card_vs_cpu(dev)
    log("[26c] cli/segm_accuracy.py: ViTClassifier ViT-B/16, 224 px, 1000 classes")
    paths.update(segm_accuracy_phase(dev))
    log("[26d] the launchers: segm_inference, show_attn_map, export_ckpt")
    segm_launchers_phase(dev, root, ckpt)
    for d in ("vit_b32", "vit_b32_amp", "narrow_cpu", "narrow_card"):
        shutil.rmtree(os.path.join(SEGM_DIR, d), ignore_errors=True)
    log(f"  phase 26: {time.perf_counter() - t0:.1f} s on {nvidia_smi_line()}")
    return paths


def segm_alone() -> int:
    """--segm: build the codec, then phase 26."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["jpeg"])
    segm_phases(torch.device("cuda"))
    return 0


# ------------------------------------------- the convergence gates: phase 27

CONVERGE_DIR = os.path.join(os.path.dirname(DATA_DIR), "converge")
# tests/test_convergence.py's floors (:55, :66, :148): best val mIoU, and
# for the supervised gate test-on-best
CONVERGE_FLOORS = {"supervised": {"best_val_miou": 0.40, "test_miou1_epoch": 0.30},
                   "flow_supervised": {"best_val_miou": 0.12}}


def converge_gate(method, root, log_dir, run_name) -> dict:
    """tests/test_convergence.py's gate config (:33-47, :118-132)."""
    return {
        "method": method,
        "trainer": {"max_epochs": 30, "seed": 1, "log_dir": log_dir, "run_name": run_name,
                    "num_devices": 1, "early_stopping_patience": 1000},
        "model": {"arch": "pspnet", "layers": 50, "classes": 5, "test_base_size": 128,
                  "optim": {"lr": 0.01}, "loss": {"min_kept": 200}, "pretrained": False,
                  "save_video": False, "save_images": False},
        "data": {"data_root": root, "data_variant": "all", "batch_size": 4, "train_w": 65,
                 "workers": 2, "resize_h": 96, "resize_w": 128, "scale_min": 0.8,
                 "scale_max": 1.2, "frame_delta": 5, "predict_v_id": "synth"},
    }


def converge_config(method, root, log_dir, run_name):
    """The gate's Config through the port's ``load_config``, its values as
    dot-path overrides on the defaults (no YAML reader needed)."""
    from floodseg_tpu_torch.core.config import load_config

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    return load_config([], dict(flat(converge_gate(method, root, log_dir, run_name))))


def converge_tree() -> str:
    """tests/test_convergence.py's synthetic tree (the generator's seed 0)."""
    root = os.path.join(CONVERGE_DIR, "data")
    shutil.rmtree(root, ignore_errors=True)
    return generate_synthetic_dataset(root, num_frames=30, frame_delta=5, size=(96, 128),
                                      num_labeled=20)


def val_curve(run_dir) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["val_miou_epoch"] for r in map(json.loads, f) if "val_miou_epoch" in r]


def converge_fit(dev, method, root) -> dict:
    """27a / 27b: the gate's fit through ``Runner.fit`` on the card (the
    steps in float32, TF32 off), then ``restore_best`` and ``test``; each
    floor of CONVERGE_FLOORS must hold. The counters are set to 0 before the
    fit and read after the test."""
    from floodseg_tpu_torch.cli.runner import Runner

    log_dir = os.path.join(CONVERGE_DIR, "logs")
    shutil.rmtree(os.path.join(log_dir, method), ignore_errors=True)  # no resume
    runner = Runner(converge_config(method, root, log_dir, method), device=dev)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = runner.fit()
    torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    fit_launches = launch_counts()
    best = runner.logger.summary.get("best_val_miou", 0.0)
    state = runner.restore_best(state)
    t0 = time.perf_counter()
    results = runner.test(state)
    torch.cuda.synchronize(dev)
    test_s = time.perf_counter() - t0
    launches = launch_counts()
    runner.logger.close()
    got = {"best_val_miou": best, "test_miou1_epoch": results["test_miou1_epoch"]}
    curve = val_curve(runner.logger.log_dir)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  val mIoU by epoch {[round(v, 4) for v in curve]}")
    log(f"  best val mIoU {best:.4f} at epoch {runner.fit_summary['best_epoch']} (floor "
        f"{CONVERGE_FLOORS[method]['best_val_miou']}), test-on-best test_miou1_epoch "
        f"{got['test_miou1_epoch']:.4f}"
        + (f" (floor {CONVERGE_FLOORS[method]['test_miou1_epoch']})"
           if "test_miou1_epoch" in CONVERGE_FLOORS[method] else " (no floor)")
        + f"; fit {fit_s:.1f} s, test {test_s:.1f} s, peak {peak:.2f} GB on {nvidia_smi_line()}")
    log(f"  launches: the fit {fit_launches}; with the test {launches}")
    failures = [f"{k} {got[k]:.4f} < {floor}" for k, floor in CONVERGE_FLOORS[method].items()
                if not got[k] >= floor]
    if method == "flow_supervised":
        failures += [f"{k} launched {fit_launches[k]} times in the fit"
                     for k in ("grid_sample_cuda", "grid_sample_backward_cuda")
                     if fit_launches[k] <= 0]
    if failures:
        raise AssertionError(f"phase 27 {method} gate: {'; '.join(failures)}")
    return {"launches": launches, "seconds": fit_s, "peak_gb": peak, "curve": curve, **got,
            "best_path": runner.ckpt.best_path}


LAUNCH_ARGS = ["--data.train_w", "65", "--data.resize_h", "96", "--data.resize_w", "128",
               "--data.scale_min", "0.8", "--data.scale_max", "1.2",
               "--data.frame_delta", "5", "--data.predict_v_id", "synth", "--data.workers", "2",
               "--data.workers_test", "2", "--model.test_base_size", "128",
               "--model.loss.min_kept", "200", "--model.pretrained", "false",
               "--model.save_video", "false", "--trainer.max_epochs", "1",
               "--trainer.limit_train_batches", "2", "--trainer.limit_val_batches", "1",
               "--trainer.limit_test_batches", "1"]
LAUNCH_KERNELS = ("grid_sample_cuda", "grid_sample_backward_cuda", "warp_chain_cuda")


@contextlib.contextmanager
def in_repo_root():
    """The launchers take configs/ relative to the working directory, as
    scripts/*.sh do."""
    cwd = os.getcwd()
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    try:
        yield
    finally:
        os.chdir(cwd)


def launchers_phase(dev, root, flow) -> dict:
    """27c: the launchers on the card on 27b's tree, each fit cut to one
    epoch of 2 steps: ``launch train flow_supervised``, ``launch test`` and
    ``launch predict`` on its run; ``sweep experiments/lr_example.yaml
    --count 2`` as two runs in their own processes; scripts/clean.py over
    that log dir with a planted crashed run; export_ckpt of 27b's best state
    to a Lightning checkpoint, import_ckpt of it bit-equal to
    ``Runner.load_torch_ckpt``'s state, and ``test --ckpt_path`` of the
    import through K1; ``launch ingress`` stopping on a missing tool."""
    from floodseg_tpu_torch.cli import export_ckpt, import_ckpt, launch, sweep
    from floodseg_tpu_torch.cli import main as cli
    from floodseg_tpu_torch.cli.runner import Runner
    from floodseg_tpu_torch.core import yaml_subset

    log_dir = os.path.join(CONVERGE_DIR, "launch_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    on = [] if dev.type == "cuda" else ["--device", dev.type]  # the card by default
    common = ["--data.data_root", root, *LAUNCH_ARGS, "--trainer.log_dir", log_dir, *on]
    run_dir = os.path.join(log_dir, "launch")
    total = dict.fromkeys(launch_counts(), 0)
    failures = []

    def counted(name, fn, *args, need=LAUNCH_KERNELS):
        reset_launch_counts()
        t0 = time.perf_counter()
        rc = fn(*args)
        torch.cuda.synchronize(dev)
        got = launch_counts()
        for k, v in got.items():
            total[k] += v
        log(f"  {name}: exit {rc}, {time.perf_counter() - t0:.1f} s, launches {got}")
        failures.extend(f"{name}: {k} launched 0 times" for k in need if not got[k])
        if rc:
            failures.append(f"{name} exited {rc}")
        return got

    with in_repo_root():
        counted("launch train flow_supervised", launch.main,
                ["train", "flow_supervised", *common, "--trainer.run_name", "launch"])
        counted("launch test", launch.main, ["test", "flow_supervised", run_dir, *common],
                need=("grid_sample_cuda",))
        counted("launch predict", launch.main,
                ["predict", "flow_supervised", run_dir, *common],
                need=("grid_sample_cuda", "warp_chain_cuda"))
        if not os.path.exists(os.path.join(run_dir, "metrics.json")):
            failures.append("launch train wrote no metrics.json")

        sweep_yaml = os.path.join("experiments", "lr_example.yaml")
        configs = [a for n in ("train_base", "train_flow_supervised", "dataset_flow")
                   for a in ("--config", f"configs/{n}.yaml")]
        t0 = time.perf_counter()
        rc = sweep.main([sweep_yaml, "--count", "2", "--", *configs, *common])
        with open(sweep_yaml) as f:
            params = yaml_subset.load(f.read())["parameters"]
        points = sweep.sweep_points(params, 2, 0)
        log(f"  sweep {sweep_yaml} --count 2: exit {rc}, {time.perf_counter() - t0:.1f} s, "
            f"points {points}")
        if rc:
            failures.append(f"sweep exited {rc}")
        for lr, batch in points:
            d = os.path.join(log_dir, f"sweep_lr={lr}_batch_size={batch}")
            if not os.path.exists(os.path.join(d, "metrics.json")):
                failures.append(f"sweep run {d} wrote no metrics.json")
                continue
            with open(os.path.join(d, "config.json")) as f:
                resolved = json.load(f)
            if (resolved["model"]["optim"]["lr"], resolved["data"]["batch_size"]) != (lr, batch):
                failures.append(f"sweep run {d} resolved lr {resolved['model']['optim']['lr']}, "
                                f"batch {resolved['data']['batch_size']}")

        crashed = os.path.join(log_dir, "crashed", "checkpoints")
        os.makedirs(crashed)
        shutil.copy(os.path.join(run_dir, "checkpoints", "last"), os.path.join(crashed,
                                                                              "last-0.pt"))
        out = subprocess.run([sys.executable, os.path.join("scripts", "clean.py"), "--log_dir",
                              log_dir], capture_output=True, text=True, timeout=120, check=True)
        lines = out.stdout.splitlines()
        log(f"  scripts/clean.py over {len(os.listdir(log_dir))} runs: {lines}")
        if len(lines) != 1 or not lines[0].startswith(f"would delete {crashed} ("):
            failures.append(f"clean.py reported {lines}")

    gate = os.path.join(CONVERGE_DIR, "flow_supervised.yaml")
    with open(gate, "w") as f:  # JSON is YAML: the port's reader takes it
        json.dump(converge_gate("flow_supervised", root, os.path.join(CONVERGE_DIR, "logs"),
                                "flow_supervised"), f)
    lightning = os.path.join(CONVERGE_DIR, "best.ckpt")
    imported = os.path.join(CONVERGE_DIR, "imported", "best.pt")
    export_ckpt.main(["--config", gate, "--ckpt", flow["best_path"], "--out", lightning, *on])
    import_ckpt.main(["--config", gate, "--ckpt", lightning, "--out", imported, *on])
    runner = Runner(converge_config("flow_supervised", root, os.path.join(CONVERGE_DIR, "logs"),
                                    "flow_supervised"), device=dev)
    want = cpu_payload(runner.load_torch_ckpt(lightning))
    got = torch.load(imported, map_location=dev, weights_only=False)
    differ = payload_bits_differ(flat_cpu(got), want)
    # the reference's flow layout has no aux head: the import keeps the model's
    best, ours = (
        {k: v for k, v in flat_cpu(p["model"]).items() if k.split(".")[1] not in AUX_KEYS}
        for p in (torch.load(flow["best_path"], map_location="cpu", weights_only=False), got))
    moved = payload_bits_differ(ours, best)
    log(f"  export_ckpt -> import_ckpt of 27b's best state: {len(want)} payload entries, "
        f"{differ} differ from load_torch_ckpt's bit for bit; {moved} of {len(ours)} "
        f"model entries but the aux head's differ from the best checkpoint's")
    if differ or moved:
        failures.append(f"import_ckpt: {differ} entries differ from load_torch_ckpt's, "
                        f"{moved} model entries from the best checkpoint's")
    counted("test --ckpt_path <imported>", cli.main,
            ["test", "--config", gate, "--ckpt_path", imported, *on], need=("grid_sample_cuda",))
    try:
        launch.ingress(os.path.join(CONVERGE_DIR, "clip"))
        failures.append("launch ingress ran without ffmpeg and mvextractor")
    except SystemExit as e:
        log(f"  launch ingress stops: {e}")
    if failures:
        raise AssertionError(f"phase 27c: {'; '.join(failures)}")
    return {"launches": total}


def converge_phases(dev) -> dict:
    """Phase 27 (see the module note); returns its paths' records."""
    t0 = time.perf_counter()
    root = converge_tree()
    log(f"[27a] the supervised convergence gate on the card (tests/test_convergence.py:26): "
        f"PSPNet-50, 5 classes, 30 epochs, batch 4, 65 px crops, seed 1, lr 0.01, float32 "
        f"with TF32 off (tree of 30 frames at 96x128 in {time.perf_counter() - t0:.1f} s)")
    paths = {"pspnet_f32_converge_supervised": converge_fit(dev, "supervised", root)}
    log("[27b] the flow_supervised convergence gate on the card (tests/test_convergence.py:112)")
    paths["pspnet_f32_converge_flow"] = flow = converge_fit(dev, "flow_supervised", root)
    log("[27c] the launchers on the card: launch train/test/predict, sweep, clean.py, "
        "export_ckpt -> import_ckpt -> test, ingress")
    paths["pspnet_f32_launchers"] = launchers_phase(dev, root, flow)
    for p in paths.values():
        p.pop("best_path", None)
    log(f"  phase 27: {time.perf_counter() - t0:.1f} s on {nvidia_smi_line()}")
    return paths


def converge_alone() -> int:
    """--converge: build csrc/warp.cu and the codec, then phase 27."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "jpeg"])
    converge_phases(torch.device("cuda"))
    return 0


# ------------------------------------------------------------------ main

# slow-pipe conversions and functions, the divide's range check, calls
SLOW_PIPE = ("MUFU", "F2I", "I2F", "FRND", "F2F", "FCHK", "CALL")


def kernel_label(mangled: str) -> str:
    """'warp_chain_kernel<bf16, 8, 1>' from an instantiation's mangled name
    (the template arguments this file's kernels take: types and integers)."""
    m = re.search(r"([a-z_]+_kernel)I(\w*)", mangled)
    if not m:
        return mangled
    args, rest = [], m.group(2)
    while rest and rest[0] != "E":
        lit = re.match(r"L[a-z](\d+)E", rest)
        named = re.match(r"(\d+)", rest)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif named:
            n, k = int(named.group(1)), named.end()
            args.append({"__nv_bfloat16": "bf16"}.get(rest[k:k + n], rest[k:k + n]))
            rest = rest[k + n:]
        elif rest[0] == "f":
            args.append("float")
            rest = rest[1:]
        else:
            break
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_usage(log_text: str):
    """(label, registers, spill stores, spill loads) for each function in
    nvcc's -Xptxas -v output."""
    rows, fn, spill = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"(?:Function properties for|Compiling entry function) '?(\w+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append((kernel_label(fn), int(m.group(1)), *spill))
            fn, spill = None, (0, 0)
    return rows


def sass_loops(lib, kernels, tag="") -> None:
    """For each instantiation of the named kernels in the built library: its
    instructions inside loops (from a backward branch's target to the
    branch, by ``cuobjdump -sass``) and the SLOW_PIPE ones among them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("  cuobjdump not found: no SASS count")
        return
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    for func in text.split("Function : ")[1:]:
        label = kernel_label(func.splitlines()[0].strip())
        if label.split("<")[0] not in kernels:
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", func)]
        branches = [(int(t, 16), int(a, 16)) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA\s+(?:`\(\S+\)\s+)?0x([0-9a-f]+)",
            func)]
        loops = [(t, a) for t, a in branches if t < a]
        inside = [op for a, op in ins if any(t <= a <= b for t, b in loops)]
        ops = [op for _, op in ins]
        slow_in = {o: inside.count(o) for o in SLOW_PIPE if o in inside}
        slow_all = {o: ops.count(o) for o in SLOW_PIPE if o in ops}
        log(f"  SASS {tag}{label}: {len(ins)} instructions, {len(inside)} in "
            f"loops; slow-pipe in loops {slow_in or 'none'}, in all {slow_all or 'none'}")


# the kernels whose loops phase 2 counts, by source
SASS_KERNELS = {"warp": ("grid_sample_kernel", "warp_chain_kernel", "warp_chain_single_kernel"),
                "resize": ("resize_quantize_kernel",)}


def build_kernels(sources) -> None:
    """Build the sources at once (one compiler each); log ptxas's registers
    and spills and the SASS loop counts of the CUDA ones."""
    t0 = time.perf_counter()
    paths = build.build(sources)
    each = ", ".join(f"{s} {build.BUILD_INFO[s]['seconds']:.1f} s" for s in sources)
    log(f"  {' and '.join(f'csrc/{build._source(s).name}' for s in sources)} built in "
        f"{time.perf_counter() - t0:.1f} s ({each})")
    for src in sources:
        if src not in SASS_KERNELS:
            continue
        for label, regs, st, ld in ptxas_usage(build.BUILD_INFO[src]["log"]):
            log(f"  ptxas {src}.cu {label}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
        sass_loops(paths[src], SASS_KERNELS[src])


# --------------------------------------------------------------- K1 alone

# the crop route's encoding of a 433 px crop (phase 3c reads it from PSPNet-50)
CROP_FEAT_HW = (55, 55)


def k1_rows(dev) -> list:
    """Every shape the paths give K1, with the grid each gives it: (label, x
    shape, the path's dtype, grid, align_corners). Predict (bf16): each
    arch's chain head on the main path's first-window grid and its key-map
    resample on the identity grid (align_corners=True); the crop route's
    chain head and its 67x120 key-map resample. Training (float32): each
    arch's chain head and step on the training batch's crop grids."""
    mvs, dg = main_path_grids(dev)
    ml, dg_crop = crop_route_grids(dev)
    rows = []
    for arch, c, hw in (("PSPNet", 4096, FEAT_HW), ("DeepLabV3", 2048, DL_FEAT_HW),
                        ("ViT", VIT_D, VIT_TOKENS_HW)):
        rows.append((f"{arch} predict head", (1,) + hw + (c,), torch.bfloat16, mvs[0], False))
        rows.append((f"{arch} predict key resample", (1,) + hw + (c,), torch.bfloat16, dg, True))
    crop = (1,) + CROP_FEAT_HW + (4096,)
    rows.append(("crop head", crop, torch.bfloat16, ml[0], False))
    rows.append(("crop key resample 67x120", crop, torch.bfloat16, dg_crop, True))
    by_crop = {}
    for arch, (c, head_hw, grid_hw, size) in TRAIN_SHAPES.items():
        grids = by_crop.setdefault(size, train_grids(dev, crop=size))
        rows.append((f"{arch} train head", (2,) + head_hw + (c,), torch.float32,
                     grids["train-crop"], False))
        rows.append((f"{arch} train step", (2,) + grid_hw + (c,), torch.float32,
                     grids["train-crop step"], False))
    return rows


def k1_edge_cases(dev, seed=3) -> list:
    """(label, x, grid) where K1's tiles and chunks are ragged: C = 5 at an
    odd element offset (the one-element route), C = 72 (chunks of 18 float32
    or 9 bf16 vectors), a 13x13 grid onto (2, 26, 26, 768) (169 points an
    image: tiles cross the first image's end), each on random and corner
    grids; both dtypes, both align modes."""
    g = torch.Generator().manual_seed(seed)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        flat = torch.randn(1 + 2 * 13 * 13 * 5, generator=g).to(dev, dtype)
        odd = flat[1:].view(2, 13, 13, 5)
        assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
        for x, hw in ((odd, (26, 26)),
                      (torch.randn((2, 55, 55, 72), generator=g).to(dev, dtype), (27, 27)),
                      (torch.randn((2, 26, 26, 768), generator=g).to(dev, dtype), (13, 13))):
            rand = (torch.rand((2,) + hw + (2,), generator=g) * 2.4 - 1.2).to(dev)
            for what, grid in (("random", rand), ("corner", torch.full_like(rand, -1.5))):
                cases.append((f"K1 {tag} x{tuple(x.shape)} {what} grid{tuple(grid.shape)}",
                              x, grid))
    return cases


def parent_k1(parent: str):
    """Start building K1 of the checkout at ``parent``, whose
    floodseg_grid_sample takes the thirteen arguments (x, grid, out, b, h, w,
    c, gh, gw, align, dtype, vec, stream) of the one-item-a-thread design,
    from its csrc/warp.cu with this checkout's nvcc flags. Returns a function
    that waits for the build and gives K1 there as (x, grid, align) -> out."""
    src = os.path.join(parent, "floodseg_tpu_torch", "csrc", "warp.cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "libwarp-parent.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{out}")
        sass_loops(lib_path, ("grid_sample_kernel",), "the parent's ")
        lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.floodseg_grid_sample.argtypes = [p, p, p] + [i] * 9 + [p]
        lib.floodseg_grid_sample.restype = i

        def run(x, grid, align):
            b, h, w, c = x.shape
            o = torch.empty((b,) + tuple(grid.shape[1:3]) + (c,), dtype=x.dtype, device=x.device)
            vec = (c * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
            err = lib.floodseg_grid_sample(
                x.data_ptr(), grid.data_ptr(), o.data_ptr(), b, h, w, c, grid.shape[1],
                grid.shape[2], int(align), 0 if x.dtype == torch.float32 else 1, int(vec),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the parent's K1 failed to launch: error {err}")
            return o
        return run
    return finish


def k1_sweep(x, grid, align, flush, cpm) -> dict:
    """K1's time (ms) at each geometry beside the one the wrapper takes:
    blocks of 256, 512 and 1024 threads, and chunks of 128 vectors, with x
    read evict-first or not."""
    out = torch.empty((x.shape[0],) + tuple(grid.shape[1:3]) + (x.shape[3],), dtype=x.dtype,
                      device=x.device)
    vec, geo = _sample_plan(x, grid, out)
    points = grid.shape[0] * grid.shape[1] * grid.shape[2]
    nv = out.shape[3] // (16 // x.element_size() if vec else 1)
    res = {}
    for lanes, threads in ((geo.lanes, 256), (geo.lanes, 512), (geo.lanes, 1024),
                           (min(nv, 128), 256)):
        for stream in (False, True):
            alt = SampleGeometry(lanes, threads // lanes * lanes, -(-nv // lanes),
                                 -(-points // (threads // lanes)), stream)
            res[f"{lanes}/{alt.threads}{' cs' if stream else ''}"
                + (" (taken)" if alt == geo else "")] = time_ms(
                lambda: _sample_launch(x, grid, out, align, vec, alt), flush, cpm)
    return res


class CleanFlush:
    """Reads a buffer larger than the 50 MB L2 before each timed launch:
    the L2 holds clean lines, so a kernel's reads evict nothing that must
    be written back (L2Flush leaves 50 MB of dirty lines)."""

    def __init__(self, device):
        self.buf = torch.ones(16 << 20, dtype=torch.float32, device=device)

    def __call__(self):
        self.buf.sum()


def k1_alone(parent=None, seed=0) -> int:
    """--k1 [PARENT]: build csrc/warp.cu (ptxas's registers and spills for
    each instantiation; the SASS slow-pipe count inside K1), then hold K1
    bit-equal to its plain version in float32 and bf16 at every shape the
    paths give it (k1_rows) on the path's own grid, random grids in both
    align modes and the corner grid, and at the ragged edge cases
    (k1_edge_cases). Then time each shape in its path's dtype beside its
    bound, its plain version and F.grid_sample, and K1 at every other
    geometry (k1_sweep). With PARENT, a checkout of the one-item-a-thread
    design, its K1 too, in turns with this one (parent, this, this, parent),
    and bit-equal to it."""
    log(f"[k1] {nvidia_smi_line()} | torch {torch.__version__} CUDA {torch.version.cuda}")
    finish = parent_k1(parent) if parent else None
    build_kernels(["warp"])
    old = finish() if finish else None
    dev = torch.device("cuda")
    rows = k1_rows(dev)
    g = torch.Generator().manual_seed(seed)
    for label, shape, _, grid, align in rows:
        xs = torch.randn(shape, generator=g)
        rand = (torch.rand(tuple(grid.shape), generator=g) * 2.2 - 1.1).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = xs.to(dev, dtype)
            tag = str(dtype).replace("torch.", "")
            for what, gr, al in (("path", grid, align), ("random", rand, False),
                                 ("random", rand, True), ("corner", torch.full_like(grid, -1.5),
                                                          align)):
                check_k1(f"K1 {tag} {label} x{shape} {what} grid{tuple(gr.shape)} align={al}",
                         x, gr, al)
    for name, x, grid in k1_edge_cases(dev):
        for align in (False, True):
            check_k1(f"{name} align={align}", x, grid, align)
    flush, clean_flush, cpm = L2Flush(dev), CleanFlush(dev), sleep_cycles_per_ms()
    one_x = torch.randn((1, 1, 1, 8), generator=g).to(dev, torch.bfloat16)
    one_grid = torch.zeros((1, 1, 1, 2), device=dev)
    log("  fixed cost: an empty launch (torch.cuda._sleep(0)) "
        f"{time_ms(lambda: torch.cuda._sleep(0), flush, cpm):.4f} ms; K1 at one point of 16 "
        "bytes (a launch, the grid's and the taps' round trips) "
        + ", ".join(f"{what} {time_ms(lambda: grid_sample_cuda(one_x, one_grid), f, cpm):.4f} ms"
                    for what, f in (("L2Flush", flush), ("CleanFlush", clean_flush))))
    for label, shape, dtype, grid, align in rows:
        x = torch.randn(shape, generator=g).to(dev, dtype)
        r = time_k1(x, x.permute(0, 3, 1, 2).contiguous(), grid, grid.to(dtype), align, flush,
                    cpm)
        line = (f"  {label} x{shape} {str(dtype).replace('torch.', '')} -> "
                f"{tuple(grid.shape[1:3])} align={align}: ")
        if old:
            differ = bits_differ(old(x, grid, align), grid_sample_cuda(x, grid, align))
            if differ:
                raise AssertionError(f"{label}: the parent's K1 differs in {differ} elements")
            turns = [time_ms(fn, flush, cpm) for fn in (
                lambda: old(x, grid, align), lambda: grid_sample_cuda(x, grid, align),
                lambda: grid_sample_cuda(x, grid, align), lambda: old(x, grid, align))]
            r["ms"] = (turns[1] + turns[2]) / 2
            line += (f"parent {turns[0]:.4f} / {turns[3]:.4f}, kernel {turns[1]:.4f} / "
                     f"{turns[2]:.4f} ms (turns); ")
        line += (f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ({r['bound_by']}) -> "
                 f"{r['bound_ms'] / r['ms']:.1%} of bound; plain {r['plain_ms']:.4f}, "
                 f"F.grid_sample {r['library_ms']:.4f}")
        log(line)
        if old:
            clean = [time_ms(fn, clean_flush, cpm) for fn in (
                lambda: old(x, grid, align), lambda: grid_sample_cuda(x, grid, align),
                lambda: grid_sample_cuda(x, grid, align), lambda: old(x, grid, align))]
            log(f"    L2 of clean lines (CleanFlush): parent {clean[0]:.4f} / {clean[3]:.4f}, "
                f"kernel {clean[1]:.4f} / {clean[2]:.4f} ms (turns)")
        else:
            log(f"    L2 of clean lines (CleanFlush): kernel "
                f"{time_ms(lambda: grid_sample_cuda(x, grid, align), clean_flush, cpm):.4f} ms")
        sweep = k1_sweep(x, grid, align, flush, cpm)
        log("    geometries (lanes/threads, cs: evict-first): "
            + ", ".join(f"{k} {v:.4f}" for k, v in sweep.items()))
    return 0


def k2_alone(seed=0) -> int:
    """--k2: build csrc/warp.cu, check K2 in float32 and bf16 (phase 3's
    cases and the degenerate grids), then time it in bf16 on the main
    path's first-window grids from K1's output on a seeded 65x65x4096 key
    encoding, and on seeded random grids of the same shape, since bank
    conflicts in the gather depend on the grid."""
    log(f"[k2] {nvidia_smi_line()} | torch {torch.__version__} CUDA {torch.version.cuda}")
    build_kernels(["warp"])
    dev = torch.device("cuda")
    mvs, dg = main_path_grids(dev)
    for dtype in (torch.float32, torch.bfloat16):
        x, _, y0, grids, y0w, gridsw = kernel_cases(dev, dtype)
        check_k2(x, y0, grids, y0w, gridsw, mvs, dg)
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, 65, 65, 4096), generator=g).to(dev, torch.bfloat16)
    y0 = grid_sample_cuda(x, mvs[0], False)
    rand = (torch.rand(tuple(mvs[1:].shape), generator=g) * 2.2 - 1.1).to(dev)
    for what, gs in (("main-path grids", mvs[1:]), ("random grids", rand)):
        r = time_k2(y0, gs, flush, cpm, full=False)
        log(f"  warp_chain_cuda y0{tuple(y0.shape)} bf16, {what} T={gs.shape[0]}: kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) -> "
            f"{r['bound_ms'] / r['ms']:.1%} of bound")
    return 0


def k3_alone(seed=0) -> int:
    """--k3: build csrc/resize.cu, then phase 3 for K3 on a seeded stack of
    the int8 main path's shape (24x32x32x4096 bf16, scale from its absmax).
    The stack is post-ReLU like the encoder features the path blends (half
    of its lanes 0); it is timed again as drawn, without the ReLU, since a
    kernel's cost can depend on the data."""
    log(f"[k3] {nvidia_smi_line()} | torch {torch.__version__} CUDA {torch.version.cuda}")
    build_kernels(["resize"])
    g = torch.Generator().manual_seed(seed)
    drawn = (torch.randn((FRAME_DELTA - 1, 32, 32, 4096), generator=g) * 3).to(
        "cuda", torch.bfloat16)
    stack = drawn.clamp_min(0)
    scale = quant.scale_from_absmax(stack.float().abs().amax())
    check_k3(stack, scale)
    for what, x in (("post-ReLU", stack), ("as drawn", drawn)):
        log(f"  stack {what}:")
        time_k3(x, quant.scale_from_absmax(x.float().abs().amax()))
    return 0


def k1_bwd_alone() -> int:
    """--k1-bwd: build csrc/warp.cu, then phase 3t's checks and timings of
    K1 and K1-bwd at every architecture's training shapes, and K1-bwd's
    workspace route and grad_out at an odd offset."""
    log(f"[k1-bwd] {nvidia_smi_line()} | torch {torch.__version__} CUDA {torch.version.cuda}")
    build_kernels(["warp"])
    dev = torch.device("cuda")
    for arch in TRAIN_SHAPES:
        check_train_kernels(dev, arch)
    check_k1_bwd_workspace(dev)
    check_k1_bwd_unaligned(dev)
    return 0


def gan_alone() -> int:
    """--gan: build csrc/warp.cu and the codec, then phases 4g, 19 and 20."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "jpeg"])
    gan_phases(torch.device("cuda"))
    return 0


def u2pl_alone() -> int:
    """--u2pl: build csrc/warp.cu and the codec, then phases 4u and 21."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "jpeg"])
    u2pl_phases(torch.device("cuda"))
    return 0


def train_alone() -> int:
    """--train: build csrc/warp.cu and the codec, then phases 3t, 4t and 14-17."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "jpeg"])
    training_phases(torch.device("cuda"))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--k2"]:
        return k2_alone()
    if sys.argv[1:] == ["--k3"]:
        return k3_alone()
    if sys.argv[1:] == ["--train"]:
        return train_alone()
    if sys.argv[1:] == ["--k1-bwd"]:
        return k1_bwd_alone()
    if sys.argv[1:] == ["--gan"]:
        return gan_alone()
    if sys.argv[1:] == ["--test"]:
        return test_alone()
    if sys.argv[1:] == ["--u2pl"]:
        return u2pl_alone()
    if sys.argv[1:] == ["--cli"]:
        return cli_alone()
    if sys.argv[1:] == ["--ddp"]:
        return ddp_alone()
    if sys.argv[1:] == ["--ddp-faults"]:
        return ddp_faults_alone()
    if sys.argv[1:] == ["--int8-enc"]:
        return int8_enc_alone()
    if sys.argv[1:] == ["--remat"]:
        return remat_alone()
    if sys.argv[1:] == ["--segm"]:
        return segm_alone()
    if sys.argv[1:] == ["--converge"]:
        return converge_alone()
    if sys.argv[1:2] == ["--ddp-rank"] and len(sys.argv) == 5:
        return ddp_rank(*sys.argv[2:])
    if sys.argv[1:2] == ["--k1"] and len(sys.argv) <= 3:
        return k1_alone(*sys.argv[2:])
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] environment: {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {name} x{torch.cuda.device_count()} | python "
        f"{sys.version.split()[0]}")

    log("[2] build (nvcc for the kernels, the host compiler for the image codec)")
    build_kernels(["warp", "resize", "jpeg"])

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = random_model("pspnet", torch.bfloat16, seed=0)
    wins = clip_windows(FRAME_DELTA, (512, 512), CLIPS_TIMED + 2, SIZE, dev)
    log(f"  set-up {time.perf_counter() - t0:.1f} s: PSPNet-50 bf16, {len(wins)} "
        f"windows of {FRAME_DELTA} frames, key frames "
        f"{tuple(wins[0]['frame_prev'].shape)}, grids {tuple(wins[0]['mvs_left'].shape)}")

    log("[3] kernels against their plain versions (main-path shapes)")
    errs = check_kernels(dev)
    stack, scale = capture_k3_input(model, wins, dev)
    errs["resize_quantize_int8_cuda"] = check_k3(stack, scale)
    timing = time_kernels(dev)
    timing["resize_quantize_int8_cuda"] = time_k3(stack, scale)
    del stack

    log("[3d] the kernels at the DeepLabV3 path's shapes (C = 2048)")
    t0 = time.perf_counter()
    dl_model = random_model("deeplabv3", torch.bfloat16, seed=0)
    dl_wins = clip_windows(FRAME_DELTA, (512, 512), CLIPS_TIMED + 2, DL_SIZE, dev)
    log(f"  set-up {time.perf_counter() - t0:.1f} s: DeepLabV3-50 bf16, key frames "
        f"{tuple(dl_wins[0]['frame_prev'].shape)}")
    dl_errs = check_kernels(dev, k1_shape=(1,) + DL_FEAT_HW + (2048,))
    stack, scale = capture_k3_input(dl_model, dl_wins, dev, size=DL_SIZE,
                                    feat_hw=DL_FEAT_HW, channels=2048)
    dl_errs["resize_quantize_int8_cuda"] = check_k3(stack, scale, feat_hw=DL_FEAT_HW,
                                                    every=False)
    dl_timing = time_kernels(dev, k1_shape=(1,) + DL_FEAT_HW + (2048,))
    dl_timing["resize_quantize_int8_cuda"] = time_k3(stack, scale, feat_hw=DL_FEAT_HW)
    del stack
    dl_model.cpu()

    log("[3v] K1 and K2 at the ViT path's shapes (C = 768)")
    vit_shape = (1,) + VIT_TOKENS_HW + (VIT_D,)
    vit_errs = check_kernels(dev, k1_shape=vit_shape)
    vit_timing = time_kernels(dev, k1_shape=vit_shape)
    geo = _chain_geometry(32 * 32, VIT_D, 2, 8)
    log(f"  K2 at C = {VIT_D} bf16: {geo.c_tile}-channel tile, {VIT_D // geo.c_tile} "
        f"blocks of {geo.threads} threads on "
        f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs")

    log("[3c] K1 and K2 at the crop route's shapes (PSPNet-50, 433 px crops, C = 4096)")
    crop_errs, crop_timing = check_crop_kernels(model, dev)
    log("[4] slice on the card against the slice on the CPU (float32)")
    check_slice_card_vs_cpu()
    check_slice_card_vs_cpu(int8=True)
    log("[4b] int8 decode on the card against the CPU")
    check_int8_decode_card_vs_cpu(model)
    log("[4d] DeepLabV3 slice on the card against the CPU (float32)")
    check_slice_card_vs_cpu("deeplabv3")
    check_slice_card_vs_cpu("deeplabv3", int8=True)
    log("[4e] DeepLabV3 int8 decode on the card against the CPU")
    check_int8_deeplab_decode_card_vs_cpu(dl_model)
    log("[4v] ViT-B/32 slice on the card against the CPU (float32, then bf16)")
    check_slice_card_vs_cpu("vit", size=128)
    check_slice_card_vs_cpu("vit", size=128, dtype=torch.bfloat16)
    vit_model = random_model("vit", torch.bfloat16, seed=0)
    models = {"pspnet": model, "deeplabv3": dl_model, "vit": vit_model}
    names = {"pspnet": "PSPNet-50", "deeplabv3": "DeepLabV3-50", "vit": "ViT-B/32"}
    paths = {}
    for phase, arch, ws, size, int8 in (
            ("[5]", "pspnet", wins, SIZE, False),
            ("[6]", "pspnet", wins, SIZE, True),
            ("[7]", "deeplabv3", dl_wins, DL_SIZE, False),
            ("[8]", "deeplabv3", dl_wins, DL_SIZE, True),
            ("[9]", "vit", dl_wins, DL_SIZE, False)):
        tag = f"{arch}_{'int8' if int8 else 'bf16'}"
        m = models[arch]
        for held in models.values():  # its own peak memory
            if held is not m:
                held.cpu()
        log(f"{phase} main path: {names[arch]} bf16, {size} px key frames, "
            f"n = {FRAME_DELTA}, {'int8' if int8 else 'bf16'} decoder")
        r = paths[tag] = run_main_path(m, ws, int8, tag, size=size)
        log(f"  {r['fps']:.2f} frames/s (median of {PASSES} passes x {CLIPS_TIMED} "
            f"windows; passes {[round(f, 2) for f in r['fps_passes']]}), peak memory "
            f"{r['peak_gb']:.2f} GB on {smi}")
        if int8:
            other = paths[f"{arch}_bf16"]["maps"]
            agree = float((r["maps"] == other).float().mean())
            log(f"  the int8 and bf16 decoders' maps of the last timed window agree on "
                f"{agree:.4f} of pixels")
            pieces = (time_decode_pieces(m) if arch == "pspnet"
                      else time_deeplab_decode_pieces(m))
            convs = pieces.values()
            busy = r["busy_ms"]
            k3_ms = r["kernel_ms"]["resize_quantize_int8_cuda"]
            im2col = sum(p["im2col_ms"] for p in convs)
            int_mm = sum(p["int_mm_ms"] for p in convs)
            log(f"  int8 window split (ms of {busy:.3f} busy): K3 {k3_ms:.4f} (profiler), "
                f"im2col {im2col:.4f}, _int_mm {int_mm:.4f} (events, L2 flushed), the rest "
                f"{busy - k3_ms - im2col - int_mm:.4f}")

    for held in models.values():
        held.cpu()
    t_files = time.perf_counter()
    log("[10] the image codec on this machine")
    codec = codec_phase()
    log(f"[11] the cached route from files: PSPNet-50 bf16, a 512 px tree resized to {SIZE}, "
        f"n = {FRAME_DELTA} (bench.py's protocol, with and without --streaming)")
    paths["pspnet_bf16_files"] = files_phase(model, dev)
    log(f"[12] the CLI's default crop route: PSPNet-50 bf16, {FRAME_HW[0]}x{FRAME_HW[1]} "
        f"frames, {CROP} px crops, n = {FRAME_DELTA}, through run_flow_predict")
    paths["pspnet_bf16_crop"] = crop = crop_route_phase(model, dev)
    model.cpu()
    log("[12b] the crop route card vs CPU (float32, 128x192 frames, 64 px crops, n = 5)")
    crop_card_vs_cpu()
    log(f"  phases 10-12: {time.perf_counter() - t_files:.1f} s")
    t_train = time.perf_counter()
    train_errs, train_timing, train_paths = training_phases(dev)
    paths.update(train_paths)
    log(f"  phases 3t, 4t, 14-17: {time.perf_counter() - t_train:.1f} s")
    t_gan = time.perf_counter()
    gan_paths = gan_phases(dev, os.path.join(DATA_DIR, "train_tree"))
    paths.update(gan_paths)
    train_paths.update(gan_paths)
    log(f"  phases 4g, 19, 20: {time.perf_counter() - t_gan:.1f} s")
    t_eval = time.perf_counter()
    eval_errs, eval_timing, test_paths, phases = evaluation_phases(
        dev, os.path.join(DATA_DIR, "train_tree"), model, wins)
    paths.update(test_paths)
    paths["pspnet_bf16_phases"] = phases
    log(f"  phases 18, 18k, 18c, 5p: {time.perf_counter() - t_eval:.1f} s")
    t_u2pl = time.perf_counter()
    u2pl_paths = u2pl_phases(dev, os.path.join(DATA_DIR, "train_tree"))
    paths.update(u2pl_paths)
    train_paths.update(u2pl_paths)
    log(f"  phases 4u, 21: {time.perf_counter() - t_u2pl:.1f} s")
    t_cli = time.perf_counter()
    log("[22] the CLI on the card: fit, test --ckpt_path last, predict (no_cropping, int8)")
    paths["pspnet_f32_cli"] = cli_phase(dev, os.path.join(DATA_DIR, "train_tree"))
    log(f"  phase 22: {time.perf_counter() - t_cli:.1f} s")
    log("[23] data parallelism: one rank over NCCL, two gloo ranks on the card, DP predict")
    paths.update(ddp_phase(dev, os.path.join(DATA_DIR, "train_tree")))
    t_opt = time.perf_counter()
    paths.update(int8_encoder_phases(dev))
    log(f"  phase 24: {time.perf_counter() - t_opt:.1f} s")
    t_opt = time.perf_counter()
    remat_paths = remat_phases(dev, os.path.join(DATA_DIR, "train_tree"))
    paths.update(remat_paths)
    train_paths.update({k: v for k, v in remat_paths.items() if "step_ms" in v})
    log(f"  phase 25: {time.perf_counter() - t_opt:.1f} s")
    paths.update(segm_phases(dev))
    paths.update(converge_phases(dev))

    sources = {"grid_sample_cuda": ("floodseg_tpu/ops/pallas_warp.py:70", "warp.cu"),
               "grid_sample_backward_cuda": (
                   "none: XLA's autodiff of floodseg_tpu/ops/grid_sample.py:79", "warp.cu"),
               "warp_chain_cuda": ("floodseg_tpu/ops/pallas_warp.py:139", "warp.cu"),
               "resize_quantize_int8_cuda": ("floodseg_tpu/ops/pallas_resize.py:135",
                                             "resize.cu")}
    # K1-bwd's main numbers are at the shape of 46 of a step's 48 launches
    timing["grid_sample_backward_cuda"] = train_timing[
        "grid_sample_backward_cuda (train step, float32)"]
    key = "grid_sample_cuda (identity grid, align_corners=True)"
    extra_rows = {"grid_sample_cuda": {
        "key_resample": timing[key], "deeplabv3_key_resample": dl_timing[key],
        "vit_key_resample": vit_timing[key],
        "crop": crop_timing["grid_sample_cuda (crop -> 27x27)"],
        "crop_key_resample": crop_timing[
            "grid_sample_cuda (crop -> 67x120 identity, align_corners=True)"],
        "test_head_f32": eval_timing["grid_sample_cuda (test head, float32)"],
        "test_step_f32": eval_timing["grid_sample_cuda (test step, float32)"],
        "test_whole_head_f32": eval_timing["grid_sample_cuda (test whole head, float32)"],
        "test_whole_step_f32": eval_timing["grid_sample_cuda (test whole step, float32)"]},
        "grid_sample_backward_cuda": {
            "workspace_f32": train_timing[
                "grid_sample_backward_cuda (workspace route, float32)"]},
        "warp_chain_cuda": {"crop": crop_timing["warp_chain_cuda (27x27, 23 steps)"]}}
    # the training rows, "train_{head,step}_f32[_arch]" (K1-bwd's PSPNet step
    # row is its main timing above)
    for arch in TRAIN_SHAPES:
        label, suffix = ("", "") if arch == "pspnet" else (f"{arch} ", f"_{arch}")
        for kname in ("grid_sample_cuda", "grid_sample_backward_cuda"):
            for part in ("head", "step"):
                if (kname, arch, part) != ("grid_sample_backward_cuda", "pspnet", "step"):
                    extra_rows[kname][f"train_{part}_f32{suffix}"] = train_timing[
                        f"{kname} ({label}train {part}, float32)"]
        extra_rows["grid_sample_backward_cuda"][f"train_head_bf16{suffix}"] = train_timing[
            f"grid_sample_backward_cuda ({label}train head, bf16)"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for kname, (replaces, src) in sources.items():
        t = timing[kname]
        by_path = {p: r["launches"][kname] for p, r in paths.items()}
        by_dtype = {}
        for e in (errs, dl_errs, vit_errs, crop_errs, train_errs, eval_errs):
            for tag, v in e.get(kname, {}).items():
                by_dtype[tag] = max(by_dtype.get(tag, 0.0), v)
        kernels.append({
            "name": kname, "route": "cuda", "source": f"floodseg_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(by_dtype.values()), "max_abs_err_by_dtype": by_dtype,
            **{k: t[k] for k in keys},
            **({"deeplabv3": {k: dl_timing[kname][k] for k in keys}} if kname in dl_timing
               else {}),
            **({"vit": {k: vit_timing[kname][k] for k in keys}} if kname in vit_timing
               else {}),
            **{shape: {k: r[k] for k in keys} for shape, r in extra_rows.get(kname, {}).items()},
            "passed": True})
    log(f"  codec {json.dumps({k: round(v, 3) for k, v in codec.items()})}; crop route "
        f"{crop['seconds']['predict_interference']:.3f} s a window; training ms a step "
        f"{ {tag: round(r['step_ms'], 1) for tag, r in train_paths.items()} }; test s a "
        f"sample { {tag: round(r['s_a_sample'], 3) for tag, r in test_paths.items()} }")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
