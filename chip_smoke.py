#!/usr/bin/env python3
"""Drive the PyTorch port (mmtrack_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one result line each; any failure raises, so the exit code is
non-zero:

  0. card: name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for matmuls and convolutions.
  1. build: compile the kernels of mmtrack_torch/csrc (nvcc, first use);
     every GEMM variant must contain wgmma (HGMMA) and TMA loads (UTMALDG)
     in its SASS (cuobjdump -sass) and show no spill in its ptxas report.
  2. kernels against their plain PyTorch versions at the tracking paths'
     shapes (phase 3's B=16 and phase 9's B=8): the attention and MLP
     half-blocks in bf16 at B=16 and 8 for every token count the path
     gives them (L = 320, 244, 190, 153), bar two bf16
     ulps of the largest |x|, |y - x| or |y| in the element's token row:
     kernel and plain sum in another f32 order, so a few bf16 roundings in
     the block flip by one ulp, and y = x + h then differs by at most one
     ulp of h plus one of y (near-zero outputs differ by many of their own
     ulps but not of their row's scale); the attention kernel alone
     (through flash_mhsa_qkv) at B=16 and the same L, as phase 5 measures
     it; the GEMM alone for the four products (qkv, proj, fc1, fc2) at
     M = 16 L and 8 L and at the training block's 32 x 320, against its plain
     epilogue, same bar, with device TFLOP/s, the wrapper's host time,
     torch.matmul's device time and the tile plan; the LayerNorm kernel at
     M = 16 L and 8 L against its byte bound; the batched crop at S = 128
     and 256 on 320x240 and 640x480 frames of 6 channels (B=16, and B=8 on
     640x480), at Alpha-Refine's S = 256 on 640x480 frames of 3, and at
     the zoo's shapes on 640x480: S = 320 at factor 5 on 3 and 6
     channels, SAMF's outer scales (factors 4.0 and 6.25, 6 channels) on
     boxes whose windows overhang every edge, and ProMixTrack's 3-channel
     S = 128 template; bar bit equality; ViPT's prompt step (ops/prompt.py)
     against prompt_step_plain at B=32 for block 0's form and every token
     count (L_a = 320, 244, 190, 153, live rows random per lane), bar two
     ulps of the row's scale on the tokens and the new state, each row
     with its plain time and byte bound. Times from CUDA events and the
     profiler's device time.
  3. main path: BatchedViPTTracker with deep_rgbd in bf16 on seeded random
     weights, B=16 sequences of 320x240 6-channel synthetic frames,
     initialize + 16 tracked steps. The launch counters must show 9 x 16
     attention half-blocks, 12 x 16 MLP half-blocks, 12 x 16 prompt steps
     and 1 + 16 crops; every
     box must be finite and inside its frame. Reports ms/step and frames/s.
     Then PROFILE_STEPS more steps under torch.profiler: the attention,
     GEMM and LayerNorm kernels' device ms and calls per step (9 attention
     and 42 GEMM calls asserted), the top kernels, all device work.
 3b. scan: the same model, frames and init as the chunked device-resident
     cell of the JAX bench (bench.py:400-418): chunks of T=16 frames for
     B=16 sequences, 4 chunks, best of 2 repetitions each ending in a host
     read of the boxes; first the eager vipt_track_scan_batched (the step
     loop, kernels on the card), then make_track_scan (one CUDA graph per
     chunk) from the same initial state. The graph's boxes and scores over
     the 4 x 16 frames must equal the eager loop's bit for bit and lie
     inside their frames; the wrappers count (warm-up + T) steps at capture
     (12 prompt steps a step among them) and nothing at replay;
     torch.profiler over one replayed chunk must count 9 attention, 42
     GEMM, 21 LayerNorm, 1 crop and 24 prompt kernels per step.
     Prints ms/step and frames/s of both, and the device ms per step and
     idle share of both (profiler windows of one chunk).
  4. one full forward with the kernels against the same model on the plain
     versions (use_kernels=False), same inputs: without candidate
     elimination the score and size maps within MAP_BAR and the offset map
     within OFFSET_REL_BAR of its largest magnitude; with elimination (the
     main path) the CE agreement, map and box differences are printed.
  5. training (mmtrack_torch.train): flash_mhsa_qkv against its plain
     version at B=32, L = 320 / 244 / 190 / 153, bar MHSA_ULPS bf16 ulps of
     the row's largest |output| (the two sum logits and probabilities in
     another f32 order, so a probability or an output rounds one ulp the
     other way), with the kernel's, the plain version's and
     F.scaled_dot_product_attention's device times from the profiler
     beside the CUDA-event times; forward + backward of each kernel's
     autograd Function against plain autograd (gradients equal: the
     backward is the plain version's, recomputed), times from CUDA events.
     Then prompt-only training of deep_rgbd at B=32, bf16 compute and f32
     parameters: one batch from the port's sampler, processing and loader
     on synthetic sequences, then device-resident random batches; 2
     warm-up + 4 counted steps in each of three modes, with exact launch
     counts per step
     (flash_mhsa_qkv / attn_block_fused / mlp_block_fused): drop path with
     CE keep 0.7, 8/1/1; drop path in the CE warm-up, 11/1/1; no drop path,
     0/9/12. Every loss finite, every prompt leaf moved, every frozen leaf
     bit-unchanged; ms/step, samples/s and peak memory.
  6. one training step's loss and prompt gradients with the kernels and
     with use_kernels=False (same weights, batch and drop-path generator):
     without CE within TRAIN_LOSS_REL_BAR and TRAIN_GRAD_REL_BAR (relative
     L2), with CE printed only. Every run decodes its boxes at the plain
     bf16 run's score-map argmax, so a near-tie that one ulp flips cannot
     move a box; printed beside the bars: the samples whose own argmax
     differs, and how close the plain map's top two scores come.
  7. xcorr: the depthwise-correlation kernel against its plain version,
     bar bit equality, at Alpha-Refine's shape (N = 1 and 16 search
     features of 32 x 32 x 64 padded by one in the kernel, per-sample 3 x 3
     filters) and at the Pallas test's (3, 22, 22, 256) x (6, 6, 256) with
     a shared filter; kernel, plain and F.conv2d(groups=C) times, from CUDA
     events over back-to-back calls and from the profiler's device time,
     and the bound.
  8. vot: the VOT entry's loop (mmtrack_torch.eval.vot.run_vot_exp) over
     in-memory TraX sessions on 12 synthetic 640x480 RGB-D frames written
     as PNG files: vipt_deep_rgbd at full width (f32, seeded weights, from
     the port's registry) and Alpha-Refine at input size 256, the mask
     protocol and then the rectangle protocol, after one short warm-up
     session. Launch counts must be exact: per mask session 2 x 12 crops
     (ViPT template + 11 searches, Alpha-Refine template + 11 searches) and
     11 correlations; per rectangle session 12 crops and none. Then one
     rectangle session each of ostrack_online (colour frames; 12 crops +
     one per template refresh) and spt (12 crops) from the registry, and
     one mask session of promixtrack (rgbd_blend frames, Alpha-Refine
     masks): 2 x 12 crops + one per nomination, 11 correlations; then,
     after a 3-frame warm-up, one 10-frame rectangle session of
     det_dimp50_max (DeT, rgbcolormap frames), which launches no kernel
     of the port. Every state must decode to a frame-sized mask (or a
     finite rectangle). One refine
     on the card against the same model on the CPU (plain versions), same
     frame and box: probabilities within AR_PROB_BAR. Prints ms per frame
     split into read+compose, tracker step, refine and encode.
  9. ope: the streamed OPE path (mmtrack_torch.eval.batched_ope) at the
     JAX bench's streamed cell shape, B=8 sequences of 13 frames of 640x480
     written as a DepthTrack layout (colour JPEG + 16-bit depth PNG, from
     data/synthetic.py over a seeded depth base), deep_rgbd in bf16 on
     seeded weights, one shared make_track_scan (each step a one-frame CUDA
     graph) for three wires: host-composed frames (get_x_frame loaders),
     the rgb + JET-index wire (the default for disk rgbcolormap) and, when
     the native decoder loads, the raw 4:2:0 wire (MMTRACK_STREAM=yuv420);
     the decoder, its load error and the host's cores are printed first.
     Each wire must be the wire that ran; the rgb + index wire's boxes and
     scores must equal the host-composed frames' bit for bit, every box
     finite and inside its frame, the 4:2:0 wire within IoU 0.6 of the
     rgb + index wire. Per wire: frames/s (a streamed wire best of 2
     passes, the host-composed frames one pass, which is also the
     reference of the bit equality) and the step split: for host-composed
     frames host decode + compose / the rest; for a streamed wire decode
     wait / upload + compose / replay + host read, from one more pass of
     SplitTracker (it synchronises after the compose), under
     torch.profiler: the card's idle share over that pass, whose kernels
     must count 9 attention, 42 GEMM, 21 LayerNorm and 1 crop per step (+1
     crop at init). The wrappers count the capture (warm-up + one step) and
     one crop per init. The uploaded RGB planes against cv2's decode:
     largest LSB difference and pixels that differ. Then the entry,
     `python -m mmtrack_torch.eval.run_ope --config deep_rgbd.json
     --batched 8 --analyze` in its own process (the JSON sets TRAIN.AMP,
     so the model is bf16 and the run is named deep_rgbd): it must exit
     0, write 8 result files and a report whose
     SR/PR/NPR and F-score equal the analysis of the rgb + index wire's
     files. Last, ViPTTracker(host_preproc=True) on one sequence at f32
     against the crop kernel's tracker, on frames composed beforehand: ms
     per frame, IoU, crop launches (none and 21).
 10. zoo: the nine recipes the port added beside ViPT (ostrack,
     ostrack_online, stark_s, stark_st, spt, siamfc, mixformer_rgbd, samf,
     promixtrack), each from the registry at f32 on seeded weights (the
     MixFormers at MixFormer-L's full width), through
     eval/ope.py::run_sequence over one 13-frame 640x480 sequence of phase
     9's fixture composed as the recipe asks. Every box finite and inside
     its frame (SiamFC, which does not clip its box, its centre); crop
     launches exactly 13 + the template refreshes the tracker reported
     (none for SiamFC, whose pyramid is plain PyTorch), for the MixFormers
     1 + 12 x scales + the nominations; median ms per frame after 3
     warm-up frames; for the MixFormers also the nominations, the ring
     writes and the card's idle share over one profiled frame; one
     full-width mixformer_rgbd forward on the card against the same
     weights on the CPU (boxes within 1e-4, logits within 1e-3). The
     device rgbcolormap compose (ops/compose.py) of the sequence's 13
     frames, from the decoded RGB and raw 16-bit depth, bit-equal to the
     host composition. OSTrack-online at bf16 (build_ostrack's dtype): one
     dual-template forward with the kernels against use_kernels=False,
     phase 4's bars without CE and the CE agreement printed; a run over
     the sequence with 9 attention and 12 MLP half-blocks per frame; 3
     profiled frames that must run the attention kernel's streaming branch
     5 times a frame (L = 464, 344) and its resident branch 4 times. Last,
     `python -m mmtrack_torch.eval.run_ope --tracker spt --analyze` and the
     same with `--tracker samf`, each in its own process on that sequence:
     exit 0, a result file, and a report equal to the analysis of the
     in-process run's results. The DiMP family (PR 10): its eight recipes
     (dimp50, det_dimp50_{max,mean,mul,weightedsum,mc}, mfdimp on rgbrgb
     frames of the colour and an 8-bit thermal stand-in made from the
     depth, prdimp50 at 352 px) from the registry at f32 on seeded weights
     over the same sequence: every box finite and inside its frame, no launch of
     any of the five kernels (the sample crop is the plain `crop_at`),
     the median ms per frame, host syncs per frame from torch.cuda's sync
     debug mode over 4 more frames, the flag counts and the filter
     iterations run (and computed, masked); one profiled frame each of
     det_dimp50_max and prdimp50 (device ms, idle share, kernels; and
     the kernels, device and wall ms of its parts, each profiled alone:
     crop + backbones + features, IoU refinement, masked filter update); one
     det_dimp50_max frame on the card against the CPU from the card's
     state, same weights and draws, the not-found threshold at 0 so the
     frame refines its box (box within 1e-3 px, score within 1e-4, the
     same flag); and `run_ope --tracker det_dimp50_max
     --analyze` in its own process, its report equal to the in-process
     analysis.
 11. train_disk: training from disk. Corpora written in their own
     layouts by 8 threads: a DepthTrack fixture as phase 9's (2 sequences
     of 21 640x480 frames), a LasHeR layout of the same size, LaSOT and
     GOT-10k layouts of 2 sequences of 21 1280x720 frames each, and an LMDB
     twin of GOT-10k's images (data/minilmdb.py's writer), whose frames must equal
     the directory's. The decoder (native or cv2) and the LMDB reader (the C
     lmdb package or minilmdb) that ran are printed; then the loader's
     seconds of one B=32 batch for each corpus (names2datasets -> sampler ->
     ViPTProcessing -> BatchLoader, one producer thread). deep_rgbd at
     B=32, bf16 compute, f32 parameters, drop path with CE keep 0.7: the
     first DepthTrack batch's loss and prompt gradients with the kernels
     against the plain versions within phase 6's bars (same decode at the
     plain run's argmax); prompt-only steps from disk, a warm-up and 1
     counted, then 1 under torch.profiler (the card's idle share over the
     from-disk window), then 1 on the first batch resident on the card:
     ms/step, samples/s, the wait on the loader and peak memory, launches
     exactly 8 / 1 / 1 (flash_mhsa_qkv / attn_block_fused /
     mlp_block_fused) a step, every prompt leaf moved and every frozen leaf
     unchanged. OSTrack (every parameter trainable) from the RGB mix
     (LaSOT + GOT-10k at 1:1, 3-channel crops): a warm-up and 1 counted
     step, launches 8 / 1 / 1 a step, every leaf moved but the auxiliary
     patch embedding, which 3-channel input never reaches and which must
     equal its start times (1 - lr wd) per step (weight decay alone).
     Last, `python -m mmtrack_torch.train.run --script ostrack --config
     rgb_mix.json --bf16` and then `--script vipt --config deep_rgbd --bf16
     --init <its checkpoint>`, each in its own process with the roots in a
     local.yaml under a temporary HOME, one B=32 step each: exit 0, a
     checkpoint written, and the --init's printed counts (missing = the
     prompt leaves, unexpected = 0).
 12. atom_dcf: the ATOM and DCF families, the eight recipes atom,
     det_atom_{max,mean,mc} (rgbcolormap frames), eco, ccot, mosse and
     scsrdcf (colour frames) from the registry at f32 on seeded weights
     over a 13-frame 640x480 sequence of phase 9's fixture: every box
     finite and inside its frame (ATOM's, which its IoU refinement does
     not clip, its centre), no launch of any of the five kernels (the
     crops are the plain `crop_at`, the FFTs torch.fft), the median ms per
     frame, host syncs per frame from torch.cuda's sync debug mode over 4
     more frames with their Python sites, ATOM's flags and the CG
     iterations run; one profiled frame each of det_atom_max and eco
     (device ms, idle share, kernels); each of the two on the card against
     the CPU from the card's state on the 10th frame, whose filter update
     runs its CG (det_atom_max with the not-found threshold at 0: box
     within 1e-3 px; eco within 1e-2 px, cuFFT against pocketfft; scores
     within 1e-4); and `run_ope --tracker eco --analyze` in its own
     process, its report equal to the in-process analysis.
 13. mdnet: the MDNet family, the seven recipes mdnet (rgbcolormap
     frames of the phase-9 fixture), pymdnet, pyvital, manet, apfnet,
     dafnet and macnet (rgbrgb frames of a one-sequence LasHeR layout of
     the same frames: the colour beside phase 10's 8-bit thermal stand-in
     of the depth, both as JPEG) from the registry at f32 on seeded
     weights over the 11 frames at 640x480: every box finite and inside
     its frame, no launch of any of the five kernels (the candidate crops
     are the plain four-tap gather, the networks cuDNN and cuBLAS), the
     init in ms, the median ms per frame, the long-term and short-term
     updates and the failures, host syncs per frame over 4 more frames
     with their sites, the peak memory; one profiled long-term update
     frame each of pymdnet and apfnet (device ms, idle share, kernels);
     pymdnet and manet on the card against the CPU from the card's state
     on the 10th frame (a long-term update; box within 1e-3 px, score
     within 1e-4, the mined negatives and the top 5 equal, the fc leaves
     within 1e-4 of their largest magnitude); and `run_ope --tracker
     apfnet --dataset LasHeR --analyze` in its own process, its report
     equal to the in-process analysis.

 14. keeptrack_kys: KeepTrack and KYS, keep_track and kys from the
     registry at f32 on seeded weights over phase 10's 13-frame 640x480
     sequence: every box finite and its centre inside its frame (the IoU
     refinement comes after the step's clamp), no launch of any of the
     five kernels (the sample crop is `crop_at`, the matcher, the cost
     volume and the shifts plain PyTorch), the init in ms, the median ms
     per frame, the flags, KeepTrack's frames on each branch (low, fresh,
     match, speedup) and the matcher passes, KYS's shifted frames, host
     syncs per frame over 4 more frames with their sites, the peak memory;
     if no frame took KeepTrack's match branch, one step that forces it
     (mem_ok set, peaks on both sides), so the matcher runs on the card;
     one profiled frame of each (device ms, idle share, kernels); each on
     the card against the CPU from the card's state on the 10th frame
     (box within 1e-3 px, score within 1e-4, KeepTrack's branch and
     selected id equal, KYS's fused map within 1e-4); and `run_ope
     --tracker kys --analyze` in its own process, its report equal to the
     in-process analysis.
 15. lwl_stm: LWL and STM from the registry on the same sequence, boxes
     and masks, each on the card against the CPU, the stm entry and the
     lwl mask-protocol VOT entry (`lwl_stm_path`).
 15b. zoo_entries: the `run_ope` entries of phases 10 and 12-15 (spt,
     samf, det_dimp50_max, eco, apfnet, kys, stm), queued by each phase
     with a copy of its sequence and in-process results, run side by side
     in their own processes beside phase 18 (whose parts are checks, not
     timings), each held as its phase says.
 16. zoo_train: the dimp, det_dimp, stark (bbox, score), mixformer (bbox,
     score), siamfc, mdnet, apfnet (stages 1 at attribute 2, 2 and 3),
     kys, lwl and lwl_box scripts of train/run.py at full width, f32, on
     seeded weights and synthetic batches through the entry's own crops,
     model, trainable set, optimizer and step: 2 steps each at B=16
     (MixFormer-L at B=4, APFNet at B=8), the ms of the second, the first
     and last loss (finite), peak memory, no launch of any of the five
     kernels, one profiled step (device ms, idle share, kernels, from the
     card's activity alone, without the host's op events: `card_only_*`,
     not comparable with the CPU + CUDA windows of the other phases); one f32
     step each of dimp, mdnet, kys and lwl at B=1 on the card against the
     CPU on the same weights, batch and draws (each loss term within 1e-4
     relative, the trained leaves' relative L2 printed); and `python -m
     mmtrack_torch.train.run --script det_dimp --synthetic` and `--script
     apfnet --stage 1 --attribute 2`, each in its own process, their
     checkpoints written.
 17. learning_demo: `python -m mmtrack_torch.train.learning_demo
     --lwl_only` in its own process, started when phase 16's timed steps
     are done and run beside its CPU-bound checks: LWL trained on the card
     through the entry (4 epochs of 64 synthetic samples at B=8) under
     deterministic algorithms (the demo's LWL phase sets them), so that every run
     trains the same parameters, and its mask tracker run on 4 held-out
     sequences of 40 frames before and after; the phase fails unless the
     process exits 0 with the AUC gate passed (+0.02). It prints AUC, mean
     IoU and SR@0.5 before and after, each epoch's loss in full and the
     SHA-256 of the trained parameters, the training's seconds, the crop
     kernel's launches and the masks by kind (empty, partial, full).
 18. host_tools: over a one-sequence phase-9 fixture (13 frames of
     640x480), `python -m mmtrack_torch.eval.benchmark_suite` for
     vipt_deep_rgbd, siamfc and mosse, and each recipe's own `run_ope
     --analyze` in its own process beside it: the suite's SR / PR / F equal
     the three reports'. `python -m mmtrack_torch.eval.transform_results`
     got10k and trackingnet over the mosse results: every sequence's boxes
     in the submission zip, truncated. `python -m mmtrack_torch.demo
     --tracker vipt_deep_rgbd --dashboard --pause` over 5 frames: its
     /state and /data read over HTTP on localhost while it waits at frame
     1, one step, then resume; 4 frames tracked and 6 files written.
     native.py's polygon_iou built with g++ here and held to its numpy
     plain version within 1e-4 on seeded polygons, batch_iou_xywh to
     metrics' within 1e-12. Three main-path steps (bf16, B=16, eager)
     under utils/profiling.py::trace_profile: the Chrome trace names the
     crop, GEMM, LayerNorm and attention kernels, and the wrappers count 3
     crops, 27 attention and 36 MLP half-blocks.
 19. ddp: `python -m mmtrack_torch.parallel.dryrun --n 2` in process: two
     ranks over gloo sharing the card, each one prompt-only step of
     deep_rgbd (bf16 compute, drop path, CE keep 0.7) on its 16 rows of a
     B=32 batch, against one process on the whole batch: loss within
     1e-3 relative, parameters within 1e-3; each rank launches 8 / 1 / 1
     (flash_mhsa_qkv / attn_block_fused / mlp_block_fused) in the step; the
     sharded tracker (its lanes, a graph per rank) within 1e-2 px of the
     unsharded one, with 1 + 2 crops, 18 attention and 24 MLP half-blocks
     per rank (the initialize, a warm-up and the captured step), and
     track_split over the shards; per-rank and one-process ms/step. Then
     the same at world size 1 over NCCL. Then, side by side: `train.run
     --distributed` under `torch.distributed.run --nproc_per_node 2` for 2
     steps of vipt (deep_rgbd, f32) and siamfc at B=32 beside each
     one-process entry: the loss within 1e-3 relative, one log line
     and one checkpoint (rank 0 writes), one "done" line; and `run_ope
     --tracker mosse` under 2 ranks (a slice of the 8 sequences each) beside
     one: the result files byte-equal. Gloo on one card stages through the
     host and says nothing about NCCL across cards.
 20. heads_backbones: deep_rgbd at full width with MODEL.HEAD.TYPE CORNER
     and MLP, bf16, B=16 on phase 3's frames: the eager step loop (9 / 12
     / 1 launches a step asserted), a chunk of 16 steps as one CUDA graph
     (nothing launched at replay), each ms/step; the kernels against
     their plain versions without candidate elimination (printed with it):
     the score map and score within 5% of their own largest value (both
     are distributions over 256 cells), the boxes within MAP_BAR; an f32
     forward on the card against the CPU (each within 1e-4 of its largest
     value). SPT (f32) on the RepVGG-A0 and
     the Swin-T trunk over phase 10's 640x480 sequence: median ms a frame,
     one crop a frame and at init, boxes inside, one forward card against
     CPU (1e-4). RepVGG-A0's fused form against its three-branch form on
     the card (1e-4 of the largest value). One f32 Alpha-Refine training
     step (B=8, input 256) on the card and on the CPU: each loss term
     within 1e-4 relative, one xcorr launch. MobileNetV3-Large at 256 x
     256 and the rpe and talking-heads attentions (768 wide, 320 tokens)
     card against CPU within 1e-4 of the largest value.
 21. tools: JAX's serving opt-outs and its measuring tools, ported
     (utils/optouts.py, kernels/ab_kernels.py, train/bench_train.py,
     eval/wire_metric_ab.py). deep_rgbd bf16 built under each opt-out, one
     forward without CE on phase 3's crops: 12 / 12 / 0 launches
     (attention half-block, MLP half-block, flash_mhsa_qkv) with the
     kernels, 0 / 0 / 0 under MMTRACK_ATTN=xla, 0 / 0 / 12 under
     MMTRACK_MLP=xla (utils/optouts.py's switches for them); the maps
     within phase 3's bars of the kernels' and the boxes (decoded at the
     plain argmax) within MAP_BAR. `ab_kernels
     fwd` in both modes at B=16, T=8 (9 / 12 launches a forward fused, 0 /
     0 xla); `loop` in both modes and `crop gather`, one run each,
     launches a step at capture 9 / 12 / 1 fused, 0 / 0 / 1 xla, 9 / 12 /
     0 gather (`crop pallas` is the fused loop), boxes inside the frame
     (their distance from fused's printed); `bench_train` at
     B=32, 3 steps: finite losses, 8 / 1 / 1 launches a step
     (flash_mhsa_qkv / attn / MLP half-block); the wire A/B on 4 x 21
     frames with 200 overfit steps, host against rgbindex: SR / PR / NPR
     within 0.001. The script refuses to start with MMTRACK_ATTN,
     MMTRACK_MLP or MMTRACK_CROP set.

Every phase prints its seconds (a `<phase>_phase` line), and the last
phase line the seconds of all of them.

Every kernel in the `kernels` line carries bound_ms, the larger of its
bytes over 3.35 TB/s and its operations over the peak rate of their type
(989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 SIMT; NVIDIA's H100 SXM
data sheet), from the shapes of its row, and library_ms, one PyTorch call
that computes the same function where there is one
(F.scaled_dot_product_attention for flash_mhsa_qkv, F.conv2d(groups=C) for
the depthwise correlation, torch.matmul for the GEMM lines), timed here
and used nowhere in the port.

The line before the last is a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Without CUDA the script raises before any
result.
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from mmtrack_torch.config import vipt_experiment_config
from mmtrack_torch.data.composition import compose_x, get_x_frame
from mmtrack_torch.data.datasets import SyntheticVideoDataset
from mmtrack_torch.data.loader import BatchLoader
from mmtrack_torch.data.processing import from_config as processing_from_config
from mmtrack_torch.data.sampler import TrackingSampler
from mmtrack_torch.data.synthetic import make_synthetic_sequence
from mmtrack_torch.eval.vot import Mask, Rectangle, _decode_region, _encode_region, run_vot_exp
from mmtrack_torch.eval.vot_entry import AR_INPUT_SIZE, refiner_factory
from mmtrack_torch.kernels.build import load_library, sass_by_kernel
from mmtrack_torch.models.heads import cal_bbox
from mmtrack_torch.models.vipt import (
    ScoreTransformer,
    build_ostrack,
    build_viptrack,
    ce_keep_schedule,
    generate_ctr_mask,
)
from mmtrack_torch.models.vipt import init_weights as init_vipt_weights
from mmtrack_torch.ops.crop import crop_at, crop_resize_normalized, crop_resize_normalized_plain
from mmtrack_torch.ops.flash_attn import (
    attn_block_fused,
    attn_block_fused_plain,
    flash_mhsa_qkv,
    flash_mhsa_qkv_plain,
)
from mmtrack_torch.ops.mlp_fuse import (
    EPI_BIAS,
    EPI_BIAS_GELU,
    EPI_BIAS_RESIDUAL,
    GEMM_BN,
    gemm_bf16,
    gemm_bf16_plain,
    gemm_plan,
    layer_norm_f32,
    layernorm_bf16,
    mlp_block_fused,
    mlp_block_fused_plain,
)
from mmtrack_torch.ops.prompt import prompt_step, prompt_step_plain
from mmtrack_torch.ops.xcorr import depthwise_xcorr, depthwise_xcorr_plain
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
from mmtrack_torch.registry import TRACKER_REGISTRY, build_tracker
from mmtrack_torch.trackers.ostrack_online import OSTrackOnlineRuntime, OSTrackOnlineTracker
from mmtrack_torch.train.actor import vipt_loss
from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask
from mmtrack_torch.train.train_step import TrainState, drop_path_generator, make_train_step
from mmtrack_torch.trackers.vipt_tracker import (
    MEAN_6CH,
    SCAN_WARMUP_STEPS,
    STD_6CH,
    ViPTRuntime,
    ViPTTracker,
    make_track_scan,
    vipt_init_state,
    vipt_step_from_crop,
    vipt_track_scan_batched,
)
from mmtrack_torch.utils import optouts, profiling
from mmtrack_torch.utils.device import card_line, require_cuda

B = 16
OPE_SEQS, OPE_FRAMES, OPE_HW = 8, 13, (480, 640)   # the JAX bench's streamed cell, bench.py:47-55
BATCHES = (B, OPE_SEQS)            # the tracking batches: phase 3's and phase 9's
TOKENS = (320, 244, 190, 153)      # 64 template + 256 / 180 / 126 / 89 search tokens
OO_B = 2                           # OSTrack-online's template batch
OO_TOKENS = (464, 344, 260, 202)   # 64 template + 400 / 280 / 196 / 138 search tokens
# the phase-2 rows: OSTrack-online's four widths and, for the resident
# branch's time beside the streaming one's, L = 320 at the same batch
OO_SHAPES = tuple((OO_B, L) for L in (464, 344, 320, 260, 202))
STEPS = 16
PROFILE_STEPS = 3                  # tracking steps under torch.profiler, after the counted run
ATTENTION_KERNELS = ("attention_resident_kernel", "attention_streaming_kernel")
GEMM_KERNEL, LAYERNORM_KERNEL = "gemm_bf16_kernel", "layernorm_bf16_kernel"
CROP_KERNEL = "crop_rows_kernel"
PROMPT_KERNELS = ("prompt_proj_kernel", "prompt_out_kernel")
PROMPT_B, PROMPT_LZ, PROMPT_LX = 32, 64, 256   # the tracking cell's lanes; template, search grid
SCAN_T, SCAN_CHUNKS, SCAN_REPS = 16, 4, 2   # bench.py:47 and :409-418 (3 repetitions there)
GEMM_SHAPES = (("qkv", 2304, 768, EPI_BIAS), ("proj", 768, 768, EPI_BIAS_RESIDUAL),
               ("fc1", 3072, 768, EPI_BIAS_GELU), ("fc2", 768, 3072, EPI_BIAS_RESIDUAL))
GEMM_CALLS_PER_STEP = 2 * 9 + 2 * 12   # qkv + proj in 9 attention, fc1 + fc2 in 12 MLP half-blocks
FRAME_HW = (240, 320)
BLOCK_ULPS = 2
MAP_BAR = 0.05                     # score / size maps, values in (0, 1)
OFFSET_REL_BAR = 0.05              # offset map, relative to its largest magnitude
TRAIN_B = 32                       # TRAIN.BATCH_SIZE of deep_rgbd
TRAIN_WARMUP, TRAIN_STEPS = 2, 4   # per training mode
MHSA_ULPS = 2                      # flash_mhsa_qkv: bf16 ulps of the row's largest |output|
# one train step, kernels vs plain, CE off; measured on an H100 (700 W):
# loss 2.7e-5 relative, prompt gradients 0.0217 relative L2
TRAIN_LOSS_REL_BAR = 5e-4
TRAIN_GRAD_REL_BAR = 5e-2
VOT_FRAMES = 12
VOT_HW = (480, 640)
AR_PROB_BAR = 1e-3                 # Alpha-Refine probabilities, card (TF32 off) vs CPU
# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound(n_bytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


_ZERO: dict = {}   # the counters at each kernel wrapper's last reset_launches


def reset_launches(*fns) -> None:
    """Count the launches of each wrapper of `fns` from here (launch_counts)."""
    now = profiling.counters()
    for fn in fns:
        _ZERO[f"launches.{fn.__name__}"] = now.get(f"launches.{fn.__name__}", 0)


def launch_counts(fns) -> dict:
    """The launches of each wrapper of `fns` since its last reset_launches."""
    return profiling.launches(fns, _ZERO)


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


WINDOW_HEAD = 64                   # marker kernels that open every profiled window
HEAD_MARKER = "bitwise_not"


def window_head() -> None:
    """Open a profiled window with WINDOW_HEAD tiny kernels (an in-place
    bitwise not of one byte, which no path of the port runs) and a
    synchronize. On the card's machine a window now and then comes back
    without the records of its first kernels (a chunk's crop, a frame's
    first attention blocks, a pass's init crop); those are then markers.
    `device_rows` leaves them out."""
    head = torch.zeros(1, dtype=torch.uint8, device="cuda")
    for _ in range(WINDOW_HEAD):
        head.bitwise_not_()
    torch.cuda.synchronize()


def device_rows(kept) -> list:
    """The kernels of key_averages rows: CUDA rows without the step's own
    annotation (ProfilerStep#, a device-side span of the whole window) and
    without the window's head."""
    return [e for e in kept if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep") and HEAD_MARKER not in e.key]


def profile_window(fn, iters: int, host_ops: bool = True) -> tuple[list, float]:
    """The CUDA rows of torch.profiler's key_averages over `iters` calls of
    fn(), largest device time first, and the window's wall seconds (host
    clock, ending in a synchronize). One call runs before the window, and
    the window opens with `window_head`. With the host's op events
    (`host_ops`, CPU + CUDA activity) one more call runs in the profiler's
    warm-up step, whose events are dropped. `host_ops=False` records the
    card's activity alone in a window without that schedule: on a
    training step of 22-27k kernels it costs about half, and keeps the
    kernel records (22,124 of 22,127 and 26,918 of 26,921, where the
    scheduled CUDA-only window lost up to 621; docs/artifacts/
    tools_probe.py profile). Its device ms read 7-15 % under a CPU + CUDA
    window's and its wall carries none of the host events' cost, so its
    numbers are not comparable with a CPU + CUDA window's (phase 16 prints
    them under names of their own)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window now and then comes back without its device events
        if host_ops:
            kept = []
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: kept.extend(p.key_averages())) as prof:
                fn()
                torch.cuda.synchronize()
                prof.step()
                window_head()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                prof.step()
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                window_head()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kept = prof.key_averages()
        rows = device_rows(kept)
        if rows:
            return sorted(rows, key=lambda e: -e.self_device_time_total), wall
    raise RuntimeError("torch.profiler recorded no device time")


def cuda_events(fn, iters: int) -> list:
    """The CUDA rows of `profile_window`."""
    return profile_window(fn, iters)[0]


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn()'s kernels in ms over `iters` calls, from
    torch.profiler: what the kernels take on the card, without the host's
    issue time between calls."""
    return sum(e.self_device_time_total for e in cuda_events(fn, iters)) / iters / 1e3


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    v = v.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


def gemm_build_checks(lib) -> dict:
    """The GEMM kernels as compiled: each of the len(GEMM_BN) variants must
    contain wgmma (SASS HGMMA) and TMA loads (UTMALDG), by `cuobjdump
    -sass` of the library, and its ptxas report must show no spill."""
    log_path = lib.path.with_suffix(".log")
    text = log_path.read_text() if log_path.exists() else ""
    spills, name = {}, None
    for ln in text.splitlines():
        if "Function properties for " in ln:
            name = ln.split("Function properties for ", 1)[1].strip()
        elif name and "spill stores" in ln:
            spills[name] = ln.strip()
            name = None
    gemm_spills = {k: v for k, v in spills.items() if GEMM_KERNEL in k}
    opcodes = {k: {op: op in v for op in ("HGMMA", "UTMALDG")}
               for k, v in sass_by_kernel(lib.path).items() if GEMM_KERNEL in k}

    def no_spill(line):
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        return bool(m) and m.group(1) == "0" and m.group(2) == "0"

    ok = (len(opcodes) == len(GEMM_BN) and all(all(v.values()) for v in opcodes.values())
          and len(gemm_spills) == len(GEMM_BN) and all(map(no_spill, gemm_spills.values())))
    return dict(ok=ok, sass_opcodes=opcodes, ptxas_spills=gemm_spills,
                wgmma_notes=[ln.strip() for ln in text.splitlines() if "wgmma" in ln.lower()])


def host_us(fn, iters: int = 200) -> float:
    """Host time of one fn() call in microseconds, enqueue only (the card
    runs behind): what CUDA events do not see."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def row_ulps(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> dict:
    """The largest |got - want|, the same in bf16 ulps of the row's largest
    |x|, |got|, |want| or |want - x|, and the share of outputs that differ;
    raises if got is not finite."""
    g, w, xf = got.float(), want.float(), x.float()
    if not torch.isfinite(g).all():
        raise AssertionError("non-finite kernel output")
    err = (g - w).abs()
    scale = torch.stack([xf.abs(), g.abs(), w.abs(), (w - xf).abs()]).amax(0).amax(
        -1, keepdim=True)
    return dict(max_abs_err=err.max().item(), max_row_ulps=(err / bf16_ulp(scale)).max().item(),
                frac_differ=(err > 0).float().mean().item())


def compare_gemms(dev, gen) -> list[dict]:
    """The GEMM kernel alone against its plain version (its epilogue's
    rounding points), for the four products of the half-blocks at the
    tracking paths' M = 16 L and 8 L, the training block's 32 x 320 and
    OSTrack-online's M = 2 L (L = 464, 344, 260, 202), bar
    BLOCK_ULPS of the row's scale. Times: CUDA events, the profiler's
    device time (also with the bias epilogue alone), the wrapper's host
    time, and torch.matmul(a, w.t()) in bf16 (cuBLAS) as the library call;
    the block tile, its tiles and waves from gemm_plan."""
    rows = []
    for name, N, K, epi in GEMM_SHAPES:
        w = (torch.randn(N, K, generator=gen) * K ** -0.5).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=gen) * 0.05).to(dev)
        for M in ([b * L for b in BATCHES for L in TOKENS] + [TRAIN_B * TOKENS[0]]
                  + [n * L for n, L in OO_SHAPES]):
            a = torch.randn(M, K, generator=gen).to(dev, torch.bfloat16)
            res = (torch.randn(M, N, generator=gen).to(dev, torch.bfloat16)
                   if epi == EPI_BIAS_RESIDUAL else None)
            got = gemm_bf16(a, w, b, epi, res)
            want = gemm_bf16_plain(a, w, b, epi, res)
            torch.cuda.synchronize()
            diff = row_ulps(got, want, torch.zeros_like(want) if res is None else res)
            plan = gemm_plan(M, N, K)

            def kernel():
                return gemm_bf16(a, w, b, epi, res)

            dev_ms = device_ms(kernel)
            flops = 2 * M * N * K
            row = dict(kernel="gemm_bf16", product=name, M=M, N=N, K=K, **diff,
                       bar_row_ulps=BLOCK_ULPS, ms=cuda_ms(kernel),
                       device_ms=dev_ms, tflops=flops / dev_ms / 1e9,
                       # the same product with the bias epilogue alone: what GELU or
                       # the residual add to the kernel
                       bias_only_device_ms=(device_ms(lambda: gemm_bf16(a, w, b, EPI_BIAS))
                                            if epi != EPI_BIAS else dev_ms),
                       host_us_per_call=host_us(kernel),
                       library_ms=device_ms(lambda: torch.matmul(a, w.t())),
                       # the same host's cost of one PyTorch call, for scale
                       library_host_us_per_call=host_us(lambda: torch.matmul(a, w.t())),
                       tile=[plan.bm, plan.bn], tiles=plan.tiles, waves=plan.waves,
                       tail_fill=plan.tail_fill,
                       **bound(nbytes(a, w, b, got, *(() if res is None else (res,))), flops,
                               "bf16"))
            log("kernels", **row, card=card_line())
            if row["max_row_ulps"] > BLOCK_ULPS:
                raise AssertionError(f"gemm {name} M={M}: {row}")
            rows.append(row)
    return rows


def compare_layernorm(dev, gen) -> list[dict]:
    """The LayerNorm row kernel against its plain version at the half-blocks'
    (16 L, 768) and (8 L, 768), bar BLOCK_ULPS of the row's largest |output|; device time
    from the profiler beside the byte bound."""
    rows = []
    g = (1 + torch.randn(768, generator=gen) * 0.1).to(dev)
    b = (torch.randn(768, generator=gen) * 0.1).to(dev)
    for M in [n * L for n in BATCHES for L in TOKENS]:
        x = torch.randn(M, 768, generator=gen).to(dev, torch.bfloat16)
        got = layernorm_bf16(x, g, b, 1e-6)
        want = layer_norm_f32(x, g, b, 1e-6).to(torch.bfloat16)
        torch.cuda.synchronize()
        row = dict(kernel="layernorm_bf16", M=M, C=768,
                   **row_ulps(got, want, torch.zeros_like(want)), bar_row_ulps=BLOCK_ULPS,
                   ms=cuda_ms(lambda: layernorm_bf16(x, g, b, 1e-6)),
                   device_ms=device_ms(lambda: layernorm_bf16(x, g, b, 1e-6)),
                   # ~8 f32 operations per element: two sums, the normalisation
                   **bound(nbytes(x, g, b, got), 8 * x.numel(), "f32"))
        log("kernels", **row, card=card_line())
        if row["max_row_ulps"] > BLOCK_ULPS:
            raise AssertionError(f"layernorm M={M}: {row}")
        rows.append(row)
    return rows


def block_params(C: int, n1: int, k2: int, gen: torch.Generator, dev) -> dict:
    """LayerNorm parameters, w1 (n1, C) and w2 (C, k2) in bf16, f32 biases."""
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    bf = torch.bfloat16
    return dict(g=1 + r(C, scale=0.1), b=r(C, scale=0.1),
                w1=r(n1, C, scale=C ** -0.5).to(bf), b1=r(n1, scale=0.05),
                w2=r(C, k2, scale=k2 ** -0.5).to(bf), b2=r(C, scale=0.05))


def block_flops(name: str, n: int, L: int, C: int, n1: int, k2: int) -> float:
    """Matrix-product operations of one half-block over n sequences: the
    two GEMMs, plus q k^T and p v for the attention."""
    gemms = 2 * n * L * (C * n1 + k2 * C)
    return gemms + (4 * n * L * L * C if name == "attn_block_fused" else 0)


def compare_blocks(name, kernel, plain, C, n1, k2, extra, dev, gen,
                   shapes=tuple((n, L) for n in BATCHES for L in TOKENS)) -> list[dict]:
    p = block_params(C, n1, k2, gen, dev)
    args = (p["g"], p["b"], p["w1"], p["b1"], p["w2"], p["b2"])
    rows = []
    for n, L in shapes:
        x = torch.randn(n, L, C, generator=gen).to(dev, torch.bfloat16)
        got = kernel(x, *args, **extra)
        want = plain(x, *args, **extra)
        torch.cuda.synchronize()
        row = dict(kernel=name, B=n, L=L, **row_ulps(got, want, x), bar_row_ulps=BLOCK_ULPS,
                   ms=cuda_ms(lambda: kernel(x, *args, **extra)),
                   device_ms=device_ms(lambda: kernel(x, *args, **extra)),
                   plain_ms=cuda_ms(lambda: plain(x, *args, **extra)), library_ms=None,
                   **bound(nbytes(x, *args, got), block_flops(name, n, L, C, n1, k2), "bf16"))
        log("kernels", **row)
        if row["max_row_ulps"] > BLOCK_ULPS:
            raise AssertionError(f"{name} B={n} L={L}: {row}")
        rows.append(row)
    return rows


def crop_boxes(H: int, W: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """n boxes: inside the frame, across each edge, and tiny ones."""
    u = torch.rand(n, 4, generator=gen)
    boxes = torch.stack([u[:, 0] * (W - 60) + 10, u[:, 1] * (H - 60) + 10,
                         u[:, 2] * 40 + 8, u[:, 3] * 40 + 8], dim=1)
    boxes[0] = torch.tensor([-12.3, -7.6, 40.0, 30.0])                 # top-left edge
    boxes[1] = torch.tensor([W - 20.5, H - 15.2, 42.0, 33.0])          # bottom-right edge
    boxes[2] = torch.tensor([W * 0.5, H * 0.5, 0.6, 0.4])              # tiny: side 1-2 px
    boxes[3] = torch.tensor([W * 0.25 + 0.5, H * 0.25 + 0.5, 3.0, 5.0])  # half-pixel origin
    return boxes


def crop_read_bytes(boxes: torch.Tensor, factor: float, S: int, H: int, W: int,
                    C: int) -> int:
    """Frame bytes the crops must read: each box's square crop clipped to
    the pixels that can be sampled (rows < H - 1, columns < W - 1), and at
    most 2 S pixels a side (two bilinear taps per output pixel)."""
    total = 0
    for x, y, w, h in boxes.tolist():
        side = max(math.ceil(math.sqrt(w * h) * factor), 1)
        x1, y1 = round(x + 0.5 * w - side * 0.5), round(y + 0.5 * h - side * 0.5)
        nx = max(0, min(x1 + side, W - 1) - max(x1, 0))
        ny = max(0, min(y1 + side, H - 1) - max(y1, 0))
        total += min(nx, 2 * S) * min(ny, 2 * S) * C
    return total


def overhang_boxes(H: int, W: int) -> torch.Tensor:
    """Four boxes whose SAMF windows leave the frame: a large centred box
    (side 838 px at factor 6.25, past every edge of 640x480; past the top
    and bottom at 4.0), boxes at the top-left and bottom-right corners, and
    a 2 x 2 px box at the right edge."""
    return torch.tensor([[W * 0.5 - 75.0, H * 0.5 - 60.0, 150.0, 120.0],
                         [-20.5, -10.25, 90.0, 70.0],
                         [W - 60.0, H - 45.5, 80.0, 66.0],
                         [W - 1.5, H * 0.5, 2.0, 2.0]])


# (H, W, C, [(S, factor), ...], batch, boxes, zoo): ViPT's template and
# search crops on both frame sizes at B=16, on phase 9's 640x480 frames at
# its B=8, Alpha-Refine's 3-channel search crop (ARRuntime); the zoo's
# (phase 10) S = 320 search crops (OSTrack-online and ProMixTrack on 3
# channels, STARK / SPT / MixFormer_RGBD on 6; four boxes, the edge cases
# of crop_boxes), SAMF's outer scales (factors 5.0 x 0.8 = 4.0 and
# 5.0 x 1.25 = 6.25, exact in f32) on windows that overhang every edge,
# and ProMixTrack's 3-channel S = 128 template
CROP_CASES = (((240, 320), 6, ((128, 2.0), (256, 4.0)), B, crop_boxes, False),
              ((480, 640), 6, ((128, 2.0), (256, 4.0)), B, crop_boxes, False),
              ((480, 640), 6, ((128, 2.0), (256, 4.0)), OPE_SEQS, crop_boxes, False),
              ((480, 640), 3, ((256, 2.0),), B, crop_boxes, False),
              ((480, 640), 3, ((320, 5.0),), 4, crop_boxes, True),
              ((480, 640), 6, ((320, 5.0),), 4, crop_boxes, True),
              ((480, 640), 6, ((320, 4.0), (320, 6.25)), 4,
               lambda H, W, n, gen: overhang_boxes(H, W), True),
              ((480, 640), 3, ((128, 2.0),), 4, crop_boxes, True))


def compare_crops(dev, gen) -> list[dict]:
    """The crop kernel against its plain version, bar bit equality. No one
    PyTorch call computes the crop (grid_sample would also sample the last
    row and column, which the reference never reads): library_ms is null.
    Rows of the zoo's cases carry zoo=True."""
    rows = []
    for (H, W), C, sizes, n, make_boxes, zoo in CROP_CASES:
        mean = torch.from_numpy(MEAN_6CH[:C]).to(dev)
        std = torch.from_numpy(STD_6CH[:C]).to(dev)
        frames = torch.randint(0, 256, (n, H, W, C), generator=gen,
                               dtype=torch.uint8).to(dev)
        boxes = make_boxes(H, W, n, gen).to(dev)
        for S, factor in sizes:
            def kernel():
                return crop_resize_normalized(frames, boxes, factor, S, mean, std)

            def plain():
                return crop_resize_normalized_plain(frames, boxes, factor, S, mean, std)

            (got, rf), (want, rf_w) = kernel(), plain()
            torch.cuda.synchronize()
            row = dict(kernel="crop_resize_normalized", B=n, H=H, W=W, C=C, S=S,
                       factor=factor, zoo=zoo, max_abs_err=(got - want).abs().max().item(),
                       rf_equal=bool(torch.equal(rf, rf_w)), bar=0.0,
                       ms=cuda_ms(kernel), device_ms=device_ms(kernel),
                       plain_ms=cuda_ms(plain), library_ms=None,
                       # ~20 f32 operations per output element
                       **bound(crop_read_bytes(boxes, factor, S, H, W, C)
                               + nbytes(boxes, mean, std, got, rf), 20 * got.numel(), "f32"))
            log("kernels", **row, card=card_line())
            if row["max_abs_err"] > 0 or not row["rf_equal"]:
                raise AssertionError(f"crop B={n} H={H} C={C} S={S}: {row}")
            rows.append(row)
    return rows


def compare_prompt(dev, gen) -> list[dict]:
    """ViPT's prompt step (ops/prompt.py over csrc/prompt.cu) against
    prompt_step_plain on the same card tensors, at B = 32: a later block
    at every token count of the main path (L_a = 320 unpruned, 244 / 190 /
    153 with random live rows per lane) and block 0's form (the RGB and
    the auxiliary tokens, one LayerNorm for both), bar BLOCK_ULPS of the
    row's scale on the tokens and the new state. Product weights at a
    scale that keeps the Fovea's logits spread by a few units (its sharp
    regime, the tracking cell's weights, is tests/test_torch_cuda.py's);
    the plain products without reduced-precision reductions, as the
    kernels accumulate in f32. Bound: the tokens and the state read once
    and written once; operations of the three C <-> 8 products."""
    from mmtrack_torch.models.layers import LayerNorm
    from mmtrack_torch.models.vipt import PromptBlock

    bf, C, n = torch.bfloat16, 768, PROMPT_B
    norms = [LayerNorm(C, dtype=bf, device=dev) for _ in range(2)]
    block = PromptBlock(C, dtype=bf, device=dev)
    with torch.no_grad():
        for m in norms:
            m.weight.copy_(1 + 0.1 * torch.randn(C, generator=gen))
            m.bias.copy_(0.1 * torch.randn(C, generator=gen))
        for conv, scale in ((block.conv0_0, 0.3 * C ** -0.5), (block.conv0_1, 0.3 * C ** -0.5),
                            (block.conv1x1, 8 ** -0.5)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * scale)
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape, generator=gen))
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rows = []
    try:
        for La in (None,) + TOKENS:                   # None: block 0's form
            if La is None:
                tokens, state = [tuple((torch.randn(n, L, C, generator=gen) * 2).to(dev, bf)
                                       for L in (PROMPT_LZ, PROMPT_LX)) for _ in range(2)]
                gidx, norm_a, norm_b = None, norms[0], norms[0]
            else:
                x_cur = (torch.randn(n, La, C, generator=gen) * 2 + 0.3).to(dev, bf)
                tokens = (x_cur[:, :PROMPT_LZ], x_cur[:, PROMPT_LZ:])
                state = tuple(torch.randn(n, L, C, generator=gen).to(dev, bf)
                              for L in (PROMPT_LZ, PROMPT_LX))
                live = La - PROMPT_LZ
                gidx = (None if live == PROMPT_LX else torch.stack(
                    [torch.randperm(PROMPT_LX, generator=gen)[:live] for _ in range(n)]).to(dev))
                norm_a, norm_b = norms

            def kernel():
                return prompt_step(tokens, state, norm_a, norm_b, block, gidx)

            def plain():
                return prompt_step_plain(tokens, state, norm_a, norm_b, block, gidx)

            (out, (p_z, p_s)), (w_out, (w_z, w_s)) = kernel(), plain()
            torch.cuda.synchronize()
            w_state = torch.cat([w_z, w_s], 1)
            tok = row_ulps(out, w_out, torch.cat(tokens, 1))
            st = row_ulps(torch.cat([p_z, p_s], 1), w_state, torch.zeros_like(w_state))
            row = dict(kernel="prompt_step", B=n, L="block0" if La is None else La, C=C,
                       max_abs_err=max(tok["max_abs_err"], st["max_abs_err"]),
                       max_row_ulps=max(tok["max_row_ulps"], st["max_row_ulps"]),
                       token_row_ulps=tok["max_row_ulps"], state_row_ulps=st["max_row_ulps"],
                       bar_row_ulps=BLOCK_ULPS, ms=cuda_ms(kernel), device_ms=device_ms(kernel),
                       plain_ms=cuda_ms(plain), plain_device_ms=device_ms(plain),
                       library_ms=None,
                       **bound(nbytes(*tokens, *state, out, w_state),
                               2 * n * (PROMPT_LZ + PROMPT_LX) * 3 * 8 * C, "bf16"))
            log("kernels", **row, card=card_line())
            if row["max_row_ulps"] > BLOCK_ULPS:
                raise AssertionError(f"prompt_step B={n} L={row['L']}: {row}")
            rows.append(row)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    # the main path's shape first, as the other kernels' rows: L_a = 320
    return rows[1:2] + rows[:1] + rows[2:]


def synthetic_frames(n: int, gen: np.random.RandomState):
    """(n, B, H, W, 6) uint8 frames of B moving bright squares on texture,
    and the (B, 4) xywh boxes of frame 0."""
    H, W = FRAME_HW
    frames = np.empty((n, B, H, W, 6), np.uint8)
    bg = gen.randint(0, 80, (B, H, W, 6)).astype(np.uint8)
    pos = np.stack([gen.uniform(40, W - 90, B), gen.uniform(30, H - 70, B)], 1)
    vel = gen.uniform(-3, 3, (B, 2))
    size = np.stack([gen.uniform(24, 48, B), gen.uniform(20, 40, B)], 1)
    box0 = np.concatenate([pos, size], 1).astype(np.float32)
    for t in range(n):
        frames[t] = bg
        for s in range(B):
            x, y = (pos[s] + t * vel[s]).round().astype(int)
            w, h = size[s].astype(int)
            frames[t, s, max(y, 0):y + h, max(x, 0):x + w] = (220, 220, 220, 180, 180, 180)
    return frames, box0


def boxes_inside(boxes: np.ndarray) -> bool:
    """Every (..., 4) xywh box finite and inside the FRAME_HW frame."""
    H, W = FRAME_HW
    return bool(np.isfinite(boxes).all() and (boxes[..., :2] >= 0).all()
                and (boxes[..., 0] + boxes[..., 2] <= W + 1e-3).all()
                and (boxes[..., 1] + boxes[..., 3] <= H + 1e-3).all())


def main_path(cfg, rt, dev, frames, box0):
    model = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    # the eager step loop: a user's per-frame calls without a graph
    tracker = BatchedViPTTracker(model, dev, rt, scan=partial(vipt_track_scan_batched, rt, model))
    # warm-up (cuDNN algorithm choice, allocator), then the counted run
    tracker.initialize(frames[0], box0)
    tracker.track(frames[1])
    torch.cuda.synchronize()

    counters = (attn_block_fused, mlp_block_fused, crop_resize_normalized, prompt_step)
    reset_launches(*counters)
    tracker.initialize(frames[0], box0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_boxes = [tracker.track(frames[t])[0] for t in range(1, STEPS + 1)]
    elapsed = time.perf_counter() - t0
    launches = launch_counts(counters)

    expected = {"attn_block_fused": 9 * STEPS, "mlp_block_fused": 12 * STEPS,
                "crop_resize_normalized": STEPS + 1, "prompt_step": 12 * STEPS}
    inside = boxes_inside(np.stack(all_boxes))
    H, W = FRAME_HW
    ms = elapsed / STEPS * 1e3
    log("main_path", config="deep_rgbd", dtype="bf16", B=B, steps=STEPS, frame=f"{W}x{H}",
        ms_per_step=ms, frames_per_s=B * STEPS / elapsed, launches=launches,
        expected=expected, boxes_inside=inside, card=card_line())
    if launches != expected or not inside:
        raise AssertionError(f"main path: launches {launches} (want {expected}), "
                             f"boxes inside: {inside}")
    prof = profile_steps(tracker, frames[STEPS])
    log("main_path_profile", **prof, card=card_line())
    if (prof["attention_kernel_calls_per_step"] != 9
            or prof["gemm_kernel_calls_per_step"] != GEMM_CALLS_PER_STEP):
        raise AssertionError(f"profiled step: {prof}")
    return model, tracker, launches


def profile_steps(tracker, frame, steps: int = PROFILE_STEPS) -> dict:
    """Device time per tracking step by kernel, from torch.profiler over a
    short window of steps on one frame (after the counted run, so the
    launch counts are untouched): the attention kernel's share, the top
    kernels, and all device work."""
    rows = cuda_events(lambda: tracker.track(frame), steps)

    def per_step(names):
        sel = [e for e in rows if any(k in e.key for k in names)]
        return (sum(e.self_device_time_total for e in sel) / steps / 1e3,
                sum(e.count for e in sel) / steps)

    attn_ms, attn_calls = per_step(ATTENTION_KERNELS)
    gemm_ms, gemm_calls = per_step((GEMM_KERNEL,))
    ln_ms, ln_calls = per_step((LAYERNORM_KERNEL,))
    return dict(
        steps=steps,
        attention_kernel_ms_per_step=attn_ms, attention_kernel_calls_per_step=attn_calls,
        gemm_kernel_ms_per_step=gemm_ms, gemm_kernel_calls_per_step=gemm_calls,
        layernorm_kernel_ms_per_step=ln_ms, layernorm_kernel_calls_per_step=ln_calls,
        device_ms_per_step=sum(e.self_device_time_total for e in rows) / steps / 1e3,
        top_kernels_ms_per_step={e.key[:60]: e.self_device_time_total / steps / 1e3
                                 for e in rows[:8]})


SCAN_COUNTERS = (attn_block_fused, mlp_block_fused, crop_resize_normalized, prompt_step)
SCAN_PER_STEP = {"attn_block_fused": 9, "mlp_block_fused": 12, "crop_resize_normalized": 1,
                 "prompt_step": 12}


def scan_counts() -> dict:
    return launch_counts(SCAN_COUNTERS)


def scan_reps(scan, rt, frames, box0, chunk) -> tuple[float, list, list]:
    """SCAN_REPS runs of SCAN_CHUNKS chunks from the initial state, each
    ending in a host read of the boxes: the best wall seconds, and each
    run's boxes and scores (SCAN_CHUNKS * T, B, ...) and its launch
    counts, the init's crop left out."""
    best, runs, counts = float("inf"), [], []
    for _ in range(SCAN_REPS):
        state = vipt_init_state(rt, frames[0], torch.from_numpy(box0))
        torch.cuda.synchronize()
        before = scan_counts()
        t0 = time.perf_counter()
        out = []
        for _ in range(SCAN_CHUNKS):
            state, boxes, scores = scan(state, chunk)
            out.append((boxes.clone(), scores.clone()))   # the graph's results alias its buffers
        boxes = torch.cat([b for b, _ in out]).cpu()
        best = min(best, time.perf_counter() - t0)
        counts.append({k: v - before[k] for k, v in scan_counts().items()})
        runs.append((boxes, torch.cat([s for _, s in out]).cpu()))
    return best, runs, counts


SCAN_KERNELS = {"attention": 9, "gemm": GEMM_CALLS_PER_STEP, "layernorm": 21, "crop": 1,
                "prompt": 12 * len(PROMPT_KERNELS)}


def profile_chunk(scan, rt, frames, box0, chunk) -> dict:
    """torch.profiler over one chunk: device ms and kernel calls per step,
    and the device's idle share of the window's wall time. A window now
    and then loses a kernel's event (one crop of 16 in some runs): up to
    three windows are taken until one holds whole counts."""
    state = vipt_init_state(rt, frames[0], torch.from_numpy(box0))
    for _ in range(3):
        rows, wall = profile_window(lambda: scan(state, chunk), 1)

        def per_step(names):
            return sum(e.count for e in rows if any(k in e.key for k in names)) / SCAN_T

        kernels = {"attention": per_step(ATTENTION_KERNELS), "gemm": per_step((GEMM_KERNEL,)),
                   "layernorm": per_step((LAYERNORM_KERNEL,)), "crop": per_step((CROP_KERNEL,)),
                   "prompt": per_step(PROMPT_KERNELS)}
        if kernels == SCAN_KERNELS:
            break
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return dict(device_ms_per_step=dev_ms / SCAN_T, wall_ms_per_step=wall * 1e3 / SCAN_T,
                idle_share=1 - dev_ms / (wall * 1e3), kernels_per_step=kernels)


def scan_path(rt, dev, model, frames, box0) -> dict:
    """Phase 3b: the chunked scan, eager and as one CUDA graph per chunk,
    from the same initial state. Returns the launches counted in it."""
    chunk = frames[1:SCAN_T + 1]                                  # (T, B, H, W, 6)
    reset_launches(*SCAN_COUNTERS)
    with torch.inference_mode():
        def eager(state, frames_t):
            return vipt_track_scan_batched(rt, model, state, frames_t)

        eager_s, eager_runs, eager_counts = scan_reps(eager, rt, frames, box0, chunk)
        eager_prof = profile_chunk(eager, rt, frames, box0, chunk)

        graph = make_track_scan(rt, model, dev)
        state = vipt_init_state(rt, frames[0], torch.from_numpy(box0))
        before = scan_counts()
        graph(state, chunk)                                       # warm-up + capture + replay
        torch.cuda.synchronize()
        captured = {k: v - before[k] for k, v in scan_counts().items()}
        graph_s, graph_runs, graph_counts = scan_reps(graph, rt, frames, box0, chunk)
        graph_prof = profile_chunk(graph, rt, frames, box0, chunk)
    launches = scan_counts()

    steps = SCAN_CHUNKS * SCAN_T
    ref_boxes, ref_scores = eager_runs[0]
    equal = all(torch.equal(b, ref_boxes) and torch.equal(s, ref_scores)
                for b, s in eager_runs + graph_runs)
    diff = max((b - ref_boxes).abs().max().item() for b, _ in graph_runs)
    inside = boxes_inside(torch.cat([b for b, _ in graph_runs]).numpy())
    want = {"capture": {k: (SCAN_WARMUP_STEPS + SCAN_T) * n for k, n in SCAN_PER_STEP.items()},
            "eager_run": {k: steps * n for k, n in SCAN_PER_STEP.items()},
            "graph_run": dict.fromkeys(SCAN_PER_STEP, 0)}
    got = {"capture": captured, "eager_run": eager_counts, "graph_run": graph_counts}
    H, W = FRAME_HW
    log("scan", config="deep_rgbd", dtype="bf16", B=B, T=SCAN_T, chunks=SCAN_CHUNKS,
        reps=SCAN_REPS, frame=f"{W}x{H}",
        eager=dict(ms_per_step=eager_s / steps * 1e3, frames_per_s=B * steps / eager_s,
                   profile=eager_prof,
                   idle_share_of_best_run=1 - eager_prof["device_ms_per_step"]
                   / (eager_s / steps * 1e3)),
        graph=dict(ms_per_step=graph_s / steps * 1e3, frames_per_s=B * steps / graph_s,
                   profile=graph_prof,
                   idle_share_of_best_run=1 - graph_prof["device_ms_per_step"]
                   / (graph_s / steps * 1e3)),
        speedup=eager_s / graph_s, bit_equal=equal, graph_vs_eager_max_abs_diff_px=diff,
        boxes_inside=inside, launches=got, expected=want, card=card_line())
    kernels = graph_prof["kernels_per_step"]
    if not equal or not inside:
        raise AssertionError(f"scan: graph vs eager bit-equal {equal} (max {diff} px), "
                             f"boxes inside {inside}")
    if (captured != want["capture"] or any(c != want["eager_run"] for c in eager_counts)
            or any(c != want["graph_run"] for c in graph_counts)):
        raise AssertionError(f"scan launches: {got}, want {want}")
    if kernels != SCAN_KERNELS:
        raise AssertionError(f"scan: the replayed chunk's kernels per step {kernels}")
    return launches


def full_forward(cfg, rt, dev, model, tracker, frames):
    """The same forward with the kernels and with their plain versions.

    Without candidate elimination (every block through the attention
    kernel) the maps must agree within MAP_BAR / OFFSET_REL_BAR. With it,
    as on the main path, the kept sets can differ: with random weights the
    bf16 CE scores are nearly flat and full of ties, so a one-ulp change
    moves tokens across the cut. That run is printed, not asserted."""
    plain = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0, use_kernels=False)
    mean = torch.from_numpy(MEAN_6CH).to(dev)
    std = torch.from_numpy(STD_6CH).to(dev)
    state = tracker.state
    search, rf = crop_resize_normalized_plain(frames[STEPS], state["box"], rt.search_factor,
                                              rt.search_size, mean, std)
    mask = generate_ctr_mask(rt.template_size // rt.stride, rt.ce_template_range, dev)
    H, W = FRAME_HW

    def run(m, keep):
        kept = {}
        hooks = [m.backbone.blocks[i].register_forward_hook(
            lambda mod, inp, out, i=i: kept.__setitem__(i, out[2].sort(1).values))
            for i in rt.ce_loc]
        with torch.inference_mode():
            out = m(state["template"], search, mask, keep)
        for h in hooks:
            h.remove()
        return out, kept

    def diffs(ok_, op):
        d = {k: (ok_[k] - op[k]).abs().max().item() for k in ("score_map", "size_map")}
        d["offset_map_rel"] = ((ok_["offset_map"] - op["offset_map"]).abs().max()
                               / op["offset_map"].abs().max()).item()
        return d

    (ok_, _), (op, _) = run(model, None), run(plain, None)
    no_ce = diffs(ok_, op)
    (ck, kk), (cp, kp) = run(model, rt.ce_keep_lens), run(plain, rt.ce_keep_lens)
    moved = {i: int(sum(len(set(a.tolist()) ^ set(b.tolist())) // 2
                        for a, b in zip(kk[i], kp[i]))) for i in rt.ce_loc}
    with torch.inference_mode():
        bk, _ = vipt_step_from_crop(rt, model, state["template"], state["box"], search, rf,
                                    float(H), float(W))
        bp, _ = vipt_step_from_crop(rt, plain, state["template"], state["box"], search, rf,
                                    float(H), float(W))
    log("full_forward", max_diff_without_ce=no_ce, map_bar=MAP_BAR,
        offset_rel_bar=OFFSET_REL_BAR, max_diff_with_ce=diffs(ck, cp),
        ce_sets_identical=[int((kk[i] == kp[i]).all(1).sum()) for i in rt.ce_loc], of=B,
        ce_tokens_moved_per_layer=moved, box_max_abs_diff_px=(bk - bp).abs().max().item())
    if (no_ce["score_map"] > MAP_BAR or no_ce["size_map"] > MAP_BAR
            or no_ce["offset_map_rel"] > OFFSET_REL_BAR):
        raise AssertionError(f"full forward: kernels vs plain beyond bar: {no_ce}")


def compare_mhsa(dev, gen, batch: int) -> list[dict]:
    """The attention kernel (through flash_mhsa_qkv) against its plain
    version at L = 320 / 244 / 190 / 153, 12 heads of 64: at B=32, the
    training path's shape, and at B=16, the tracking path's (where
    attn_block_fused runs the same kernel between its two GEMMs). Times
    from CUDA events and from the profiler's device time, for the kernel,
    the plain version and F.scaled_dot_product_attention."""
    rows = []
    for L in TOKENS:
        qkv = torch.randn(batch, L, 3 * 768, generator=gen).to(dev, torch.bfloat16)
        got = flash_mhsa_qkv(qkv, 12, 64 ** -0.5)
        want = flash_mhsa_qkv_plain(qkv, 12, 64 ** -0.5)
        # the library call on q, k, v laid out (B, heads, L, 64) beforehand
        q, k, v = qkv.reshape(batch, L, 3, 12, 64).permute(2, 0, 3, 1, 4).contiguous()
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        err = (g - w).abs()
        scale = torch.maximum(g.abs(), w.abs()).amax(-1, keepdim=True)

        def kernel():
            return flash_mhsa_qkv(qkv, 12, 64 ** -0.5)

        def plain():
            return flash_mhsa_qkv_plain(qkv, 12, 64 ** -0.5)

        def library():
            return F.scaled_dot_product_attention(q, k, v)

        row = dict(kernel="flash_mhsa_qkv", B=batch, L=L, max_abs_err=err.max().item(),
                   max_row_ulps=(err / bf16_ulp(scale)).max().item(), bar_row_ulps=MHSA_ULPS,
                   frac_differ=(err > 0).float().mean().item(),
                   ms=cuda_ms(kernel), plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                   device_ms=device_ms(kernel), plain_device_ms=device_ms(plain),
                   library_device_ms=device_ms(library),
                   **bound(nbytes(qkv, got), 4 * batch * L * L * 768, "bf16"))
        log("kernels", **row, card=card_line())
        if not torch.isfinite(g).all() or row["max_row_ulps"] > MHSA_ULPS:
            raise AssertionError(f"flash_mhsa_qkv B={batch} L={L}: {row}")
        rows.append(row)
    return rows


def time_functions(dev, gen) -> list[dict]:
    """Forward + backward of each kernel's autograd Function against plain
    autograd of its plain version, at B=32, L=320, the gradient taken for
    the activations only (the training path's frozen weights)."""
    L = TOKENS[0]
    heads = dict(num_heads=12, scale=64 ** -0.5)
    cases = [("flash_mhsa_qkv", flash_mhsa_qkv, flash_mhsa_qkv_plain, (3 * 768,), heads)]
    for name, kernel, plain, n1, k2, extra in (
            ("attn_block_fused", attn_block_fused, attn_block_fused_plain, 3 * 768, 768, heads),
            ("mlp_block_fused", mlp_block_fused, mlp_block_fused_plain, 4 * 768, 4 * 768, {})):
        p = block_params(768, n1, k2, gen, dev)
        cases.append((name, kernel, plain, (768, p["g"], p["b"], p["w1"], p["b1"], p["w2"],
                                            p["b2"]), extra))
    rows = []
    for name, kernel, plain, args, extra in cases:
        x = torch.randn(TRAIN_B, L, args[0], generator=gen).to(dev, torch.bfloat16)
        x.requires_grad_(True)
        rest = args[1:]
        g_out = torch.randn(TRAIN_B, L, 768, generator=gen).to(dev, torch.bfloat16)

        def fwd_bwd(fn):
            return torch.autograd.grad(fn(x, *rest, **extra), x, g_out)[0]

        before = profiling.counters()
        got, want = fwd_bwd(kernel), fwd_bwd(plain)
        if (list(profiling.launches([kernel], before).values()) != [1]
                or not torch.equal(got, want)):
            raise AssertionError(f"{name}: the Function's gradient is not plain autograd's")
        row = dict(function=name, B=TRAIN_B, L=L, grad_equal=True,
                   fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(kernel), iters=10),
                   plain_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(plain), iters=10))
        log("functions", **row)
        rows.append(row)
    return rows


def synthetic_train_batch(cfg, dev) -> dict:
    """Device-resident random crops and boxes, as tools/bench_train.py:71-77."""
    rng = np.random.RandomState(0)
    Tz, Tx = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    host = {"template": rng.randn(TRAIN_B, Tz, Tz, 6), "search": rng.randn(TRAIN_B, Tx, Tx, 6),
            "search_anno": rng.uniform(0.2, 0.4, (TRAIN_B, 4))}
    return {k: torch.from_numpy(v).to(dev, torch.float32) for k, v in host.items()}


def state_step(state, step, batch) -> torch.Tensor:
    """One train step; its loss, left on the device."""
    _, stats = step(state, batch)
    return stats["Loss/total"]


def train_path(cfg, dev) -> dict:
    """Prompt-only training of deep_rgbd at B=32, bf16 compute, f32
    parameters: one batch from the port's data pipeline, then device
    batches, in the three modes a training run goes through. Returns the
    counted launches of each kernel."""
    stride = cfg.MODEL.BACKBONE.STRIDE
    n_search = (cfg.DATA.SEARCH.SIZE // stride) ** 2
    ce_lens = ce_keep_schedule(n_search, cfg.MODEL.BACKBONE.CE_LOC,
                               cfg.MODEL.BACKBONE.CE_KEEP_RATIO)
    mask = generate_ctr_mask(cfg.DATA.TEMPLATE.SIZE // stride,
                             cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE, dev)
    model = build_viptrack(cfg, dtype=torch.bfloat16, param_dtype=torch.float32, device=dev,
                           seed=0)
    opt, sched = build_optimizer(model, lr=cfg.TRAIN.LR, weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                                 lr_drop_step=cfg.TRAIN.LR_DROP_EPOCH
                                 * (cfg.DATA.TRAIN.SAMPLE_PER_EPOCH // TRAIN_B),
                                 decay_rate=cfg.TRAIN.SCHEDULER.DECAY_RATE,
                                 grad_clip_norm=cfg.TRAIN.GRAD_CLIP_NORM,
                                 trainable_mask=prompt_only_mask(model))
    state = TrainState(model, opt, sched)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    weights = (cfg.TRAIN.GIOU_WEIGHT, cfg.TRAIN.L1_WEIGHT, cfg.TRAIN.FOCAL_WEIGHT)

    def step_fn(lens, use_drop_path):
        return make_train_step(box_mask_z=mask, ce_keep_lens=lens, weights=weights,
                               search_size=cfg.DATA.SEARCH.SIZE, stride=stride,
                               use_drop_path=use_drop_path, seed=0)

    # one batch through the port's sampler, processing and loader
    t0 = time.perf_counter()
    sampler = TrackingSampler([SyntheticVideoDataset(n_sequences=8, n_frames=60)], None,
                              samples_per_epoch=TRAIN_B,
                              max_gap=cfg.DATA.MAX_SAMPLE_INTERVAL,
                              processing=processing_from_config(cfg), seed=0)
    loaded = next(iter(BatchLoader(sampler, TRAIN_B)))
    load_s = time.perf_counter() - t0
    shapes = {k: list(v.shape) for k, v in loaded.items()}
    Tz, Tx = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    if (shapes["search"] != [TRAIN_B, Tx, Tx, 6] or shapes["template"] != [TRAIN_B, Tz, Tz, 6]
            or not all(np.isfinite(v).all() for v in loaded.values())):
        raise AssertionError(f"loader batch: {shapes}")
    losses = [state_step(state, step_fn(ce_lens, True), loaded)]

    batch = synthetic_train_batch(cfg, dev)
    counters = (flash_mhsa_qkv, attn_block_fused, mlp_block_fused)
    counted = dict.fromkeys((fn.__name__ for fn in counters), 0)
    rows = []
    for mode, lens, use_dp, per_step in (("drop_path+ce", ce_lens, True, (8, 1, 1)),
                                         ("drop_path, ce warm-up", None, True, (11, 1, 1)),
                                         ("no drop_path", ce_lens, False, (0, 9, 12))):
        step = step_fn(lens, use_dp)
        for _ in range(TRAIN_WARMUP):
            losses.append(state_step(state, step, batch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches(*counters)
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(state_step(state, step, batch))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = launch_counts(counters)
        expected = {fn.__name__: n * TRAIN_STEPS for fn, n in zip(counters, per_step)}
        row = dict(mode=mode, B=TRAIN_B, steps=TRAIN_STEPS, ms_per_step=elapsed / TRAIN_STEPS * 1e3,
                   samples_per_s=TRAIN_B * TRAIN_STEPS / elapsed,
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                   launches=launches, expected=expected, card=card_line())
        log("train", **row)
        if launches != expected:
            raise AssertionError(f"train {mode}: launches {launches}, want {expected}")
        for name, n in launches.items():
            counted[name] += n
        rows.append(row)

    losses = [float(v) for v in losses]
    after = model.state_dict()
    moved = [k for k in after if "prompt" in k and not torch.equal(after[k], start[k])]
    n_prompt = sum("prompt" in k for k in after)
    frozen_changed = [k for k in after if "prompt" not in k and not torch.equal(after[k], start[k])]
    log("train_check", config="deep_rgbd", dtype="bf16 compute, f32 params", B=TRAIN_B,
        loader_seconds=load_s, loader_shapes=shapes, steps=len(losses), loss_first=losses[0],
        loss_last=losses[-1], all_finite=bool(np.isfinite(losses).all()),
        prompt_leaves_moved=f"{len(moved)}/{n_prompt}", frozen_leaves_changed=frozen_changed)
    if (not np.isfinite(losses).all() or len(moved) != n_prompt or frozen_changed):
        raise AssertionError("train: non-finite loss, unmoved prompt leaf or changed frozen leaf")
    return counted


def train_kernels_vs_plain(cfg, dev, batch=None, label="train_kernels_vs_plain") -> None:
    """One step's loss and prompt gradients with the kernels and with
    their plain versions (use_kernels=False): same weights, batch (the
    device-resident random batch unless `batch` is given) and drop-path
    generator. Asserted without candidate elimination, printed
    with it (tied bf16 CE scores on random weights move tokens). The same
    step at f32 compute gives the scale of bf16 rounding for comparison.

    The box loss is not continuous in the kernels' rounding: a box is
    decoded at its score map's argmax, and random weights give nearly flat
    maps, so a one-ulp change can move a sample's box to another peak.
    So every run decodes its boxes at the plain bf16 run's argmax cells
    (the size and offset maps read there, the focal loss on the whole
    score map, as in training): the bars then see the kernels' rounding
    and not the ties. Printed beside them: the samples whose own argmax
    differs between the two bf16 runs, and the smallest gap between the
    plain map's top two scores, against the largest difference between
    the two maps."""
    stride = cfg.MODEL.BACKBONE.STRIDE
    mask = generate_ctr_mask(cfg.DATA.TEMPLATE.SIZE // stride,
                             cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE, dev)
    ce_lens = ce_keep_schedule((cfg.DATA.SEARCH.SIZE // stride) ** 2,
                               cfg.MODEL.BACKBONE.CE_LOC, cfg.MODEL.BACKBONE.CE_KEEP_RATIO)
    if batch is None:
        batch = synthetic_train_batch(cfg, dev)
    results, score_maps, cells = {}, {}, {}
    for name, dtype, use_kernels, runs in (("plain", torch.bfloat16, False, (None, ce_lens)),
                                           ("kernels", torch.bfloat16, True, (None, ce_lens)),
                                           ("f32", torch.float32, False, (None,))):
        model = build_viptrack(cfg, dtype=dtype, param_dtype=torch.float32, device=dev, seed=0,
                               use_kernels=use_kernels)
        trainable = prompt_only_mask(model)
        for pname, p in model.named_parameters():
            p.requires_grad_(trainable[pname])
        for lens in runs:
            out = model(batch["template"], batch["search"], mask, lens, deterministic=False,
                        generator=drop_path_generator(0, 0, dev))
            flat = out["score_map"].detach().float().flatten(1)
            at = cells.setdefault(lens is None, flat.argmax(1))     # the plain bf16 run's
            out["pred_boxes"], _ = cal_bbox(out["score_map"], out["size_map"],
                                            out["offset_map"], at)
            loss, _ = vipt_loss(out, batch["search_anno"], search_size=cfg.DATA.SEARCH.SIZE,
                                stride=stride)
            params = [p for p in model.parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, params)
            results[name, lens is None] = (loss.detach().float(),
                                           torch.cat([g.flatten() for g in grads]))
            if dtype == torch.bfloat16 and lens is None:
                score_maps[name] = flat
        del model

    def diff(a, b):
        (la, ga), (lb, gb) = results[a], results[b]
        return dict(loss_rel_diff=((la - lb).abs() / lb.abs()).item(),
                    grad_rel_l2=((ga - gb).norm() / gb.norm()).item())

    off = diff(("kernels", True), ("plain", True))
    sk, sp = score_maps["kernels"], score_maps["plain"]
    top2 = sp.topk(2, dim=1).values
    ties = dict(argmax_differs=(sk.argmax(1) != sp.argmax(1)).nonzero().flatten().tolist(),
                plain_min_top2_gap=(top2[:, 0] - top2[:, 1]).min().item(),
                score_map_max_abs_diff=(sk - sp).abs().max().item())
    log(label,
        ce_off=dict(loss_kernels=results["kernels", True][0].item(),
                    loss_plain=results["plain", True][0].item(), **off, **ties),
        ce_on=diff(("kernels", False), ("plain", False)),
        bf16_plain_vs_f32_ce_off=diff(("plain", True), ("f32", True)),
        loss_rel_bar=TRAIN_LOSS_REL_BAR, grad_rel_l2_bar=TRAIN_GRAD_REL_BAR, asserted="ce_off",
        boxes_decoded_at="the plain bf16 run's score-map argmax")
    if off["loss_rel_diff"] > TRAIN_LOSS_REL_BAR or off["grad_rel_l2"] > TRAIN_GRAD_REL_BAR:
        raise AssertionError(f"{label}: kernels vs plain beyond bar: {off}")


XCORR_CASES = (  # (name, N, H, W, C, fh, fw, per-sample filter, pad)
    ("alpha_refine", 1, 32, 32, 64, 3, 3, True, 1),
    ("alpha_refine", 16, 32, 32, 64, 3, 3, True, 1),
    ("pallas_test", 3, 22, 22, 256, 6, 6, False, 0),
)


def compare_xcorr(dev, gen) -> list[dict]:
    """The depthwise-correlation kernel against its plain version (bit
    equality) and against F.conv2d(groups=C) on NCHW tensors laid out
    beforehand (the library call; cuDNN at f32, TF32 off)."""
    rows = []
    for name, N, H, W, C, fh, fw, per_sample, pad in XCORR_CASES:
        x = torch.randn(N, H, W, C, generator=gen).to(dev)
        z = torch.randn(*((N,) if per_sample else ()), fh, fw, C, generator=gen).to(dev)
        got = depthwise_xcorr(z, x, pad=pad)
        want = depthwise_xcorr_plain(z, x, pad=pad)
        groups = N * C if per_sample else C
        # per-sample filters: the N samples' channels side by side as N * C groups
        x_lib = x.permute(0, 3, 1, 2).reshape(-1, groups, H, W).contiguous()
        w_lib = z.permute(*((0, 3) if per_sample else (2,)), -3, -2)
        w_lib = w_lib.reshape(groups, 1, fh, fw).contiguous()

        def library():
            return F.conv2d(x_lib, w_lib, padding=pad, groups=groups)

        lib = library()
        lib = (lib.reshape(N, C, *lib.shape[2:]) if per_sample else lib).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        row = dict(kernel="depthwise_xcorr", case=name, N=N, x=[H, W, C], filter=[fh, fw],
                   per_sample=per_sample, pad=pad, max_abs_err=(got - want).abs().max().item(),
                   bar=0.0, library_max_abs_diff=(lib - want).abs().max().item(),
                   ms=cuda_ms(lambda: depthwise_xcorr(z, x, pad=pad)),
                   plain_ms=cuda_ms(lambda: depthwise_xcorr_plain(z, x, pad=pad)),
                   library_ms=cuda_ms(library),
                   **bound(nbytes(x, z, got), 2 * fh * fw * got.numel(), "f32"))
        # back-to-back calls of a microsecond kernel measure the host's
        # issue rate; the profiler gives the kernels' own device time
        row.update(device_ms=device_ms(lambda: depthwise_xcorr(z, x, pad=pad)),
                   plain_device_ms=device_ms(lambda: depthwise_xcorr_plain(z, x, pad=pad)),
                   library_device_ms=device_ms(library), bound_us=row["bound_ms"] * 1e3)
        log("xcorr", **row, card=card_line())
        if not torch.equal(got, want):
            raise AssertionError(f"depthwise_xcorr {name} N={N}: {row}")
        rows.append(row)
    return rows


def vot_sequence(root: str, n: int, seed: int = 0):
    """n synthetic 640x480 RGB-D frames as RGB PNG + 16-bit depth PNG
    files: a bright box drifting over texture, nearer than a sloped
    background. Returns (colour paths, depth paths, box of frame 0)."""
    rng = np.random.RandomState(seed)
    H, W = VOT_HW
    bg = rng.randint(0, 90, (H, W, 3)).astype(np.uint8)
    far = (3000 + 3000 * np.linspace(0, 1, H)[:, None]
           + rng.randint(0, 200, (H, W))).astype(np.uint16)
    x, y, w, h = 250.0, 180.0, 70.0, 55.0
    colors, depths = [], []
    for t in range(n):
        xi, yi = int(round(x + 3.0 * t)), int(round(y + 1.5 * t))
        rgb, depth = bg.copy(), far.copy()
        rgb[yi:yi + int(h), xi:xi + int(w)] = (230, 200, 60)
        depth[yi:yi + int(h), xi:xi + int(w)] = 1400
        c, d = os.path.join(root, f"color_{t:04d}.png"), os.path.join(root, f"depth_{t:04d}.png")
        cv2.imwrite(c, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        cv2.imwrite(d, depth)
        colors.append(c)
        depths.append(d)
    return colors, depths, (x, y, w, h)


def trax_script(colors, depths, region: str) -> str:
    lines = [f'@@TRAX:initialize "file://{colors[0]}" "file://{depths[0]}" "{region}"']
    lines += [f'@@TRAX:frame "file://{c}" "file://{d}"' for c, d in zip(colors[1:], depths[1:])]
    return "\n".join(lines + ["@@TRAX:quit", ""])


def vot_path(dev) -> dict:
    """The VOT entry's loop, mask protocol then rectangle protocol, with
    exact launch counts. Returns the launches of each kernel."""
    counters = (crop_resize_normalized, depthwise_xcorr)
    tracker = build_tracker("vipt_deep_rgbd", device=dev)          # f32, seed 0
    refiner = refiner_factory(dev)()                                # AR at 256, seed 0
    H, W = VOT_HW
    counted = dict.fromkeys((fn.__name__ for fn in counters), 0)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        colors, depths, (x, y, w, h) = vot_sequence(root, VOT_FRAMES)
        write_s = time.perf_counter() - t0
        init_mask = np.ones((int(h), int(w)), np.uint8)
        regions = {"mask": _encode_region(Mask(int(x), int(y), init_mask)),
                   "rectangle": _encode_region(Rectangle(x, y, w, h))}

        def session(protocol: str, n: int, timings=None, trk=tracker,
                    dtype="rgbcolormap") -> list:
            fout = io.StringIO()
            run_vot_exp(lambda: trk, channels="rgbd", dtype=dtype,
                        fin=io.StringIO(trax_script(colors[:n], depths[:n], regions[protocol])),
                        fout=fout, mask=protocol == "mask", refine_factory=lambda: refiner,
                        timings=timings)
            return [_decode_region(ln.split('"')[1]) for ln in fout.getvalue().splitlines()
                    if ln.startswith("@@TRAX:state")]

        session("mask", 4)                                           # warm-up
        torch.cuda.synchronize()
        for protocol, per_session in (("mask", {"crop_resize_normalized": 2 * VOT_FRAMES,
                                                "depthwise_xcorr": VOT_FRAMES - 1}),
                                      ("rectangle", {"crop_resize_normalized": VOT_FRAMES,
                                                     "depthwise_xcorr": 0})):
            timings = {}
            reset_launches(*counters)
            t0 = time.perf_counter()
            states = session(protocol, VOT_FRAMES, timings)
            elapsed = time.perf_counter() - t0
            launches = launch_counts(counters)
            if protocol == "mask":
                ok = all(isinstance(s, Mask) and (s.x, s.y) == (0, 0) and s.mask.shape == (H, W)
                         for s in states[1:])
                covered = [float(s.mask.mean()) for s in states[1:]]
            else:
                ok = all(isinstance(s, Rectangle) and np.isfinite(list(s)).all()
                         for s in states[1:])
                covered = None
            frames = timings["frames"]
            log("vot", protocol=protocol, tracker="vipt_deep_rgbd", dtype="f32",
                ar_input_size=AR_INPUT_SIZE, frames=VOT_FRAMES, frame=f"{W}x{H}",
                png_write_s=write_s, states=len(states), states_ok=ok,
                mask_area_fraction=covered, launches=launches, expected=per_session,
                ms_per_frame=elapsed / VOT_FRAMES * 1e3,
                ms_per_frame_split={k: timings[k] / frames * 1e3
                                    for k in ("read_compose", "track", "refine", "encode")},
                card=card_line())
            if len(states) != VOT_FRAMES or not ok or launches != per_session:
                raise AssertionError(f"vot {protocol}: {len(states)} states, ok {ok}, "
                                     f"launches {launches} (want {per_session})")
            for name, k in launches.items():
                counted[name] += k

        # the zoo's VOT22 RGB-D entries, rectangle protocol, from the registry
        for name in ("ostrack_online", "spt"):
            recipe = TRACKER_REGISTRY[name]
            zoo = FrameRecorder(recipe.build(device=dev))
            reset_launches(crop_resize_normalized)
            t0 = time.perf_counter()
            states = session("rectangle", VOT_FRAMES, trk=zoo, dtype=recipe.composition)
            elapsed = time.perf_counter() - t0
            crops = launch_counts([crop_resize_normalized])["crop_resize_normalized"]
            want = VOT_FRAMES + zoo.updates
            ok = len(states) == VOT_FRAMES and all(
                isinstance(st, Rectangle) and np.isfinite(list(st)).all() for st in states[1:])
            log("vot", protocol="rectangle", tracker=name, dtype="f32",
                composition=recipe.composition, frames=VOT_FRAMES, frame=f"{W}x{H}",
                states=len(states), states_ok=ok, template_updates=zoo.updates,
                crop_launches=crops, expected=want,
                ms_per_frame=elapsed / VOT_FRAMES * 1e3, card=card_line())
            if not ok or crops != want:
                raise AssertionError(f"vot {name}: states ok {ok}, crops {crops} (want {want})")
            counted["crop_resize_normalized"] += crops
            del zoo

        # ProMixTrack's VOT entry: the mask protocol, Alpha-Refine masks on
        # the rgbd_blend frames. Crops: the tracker's template, one search
        # crop a frame and one per nomination; Alpha-Refine's template and
        # one search crop a frame; one correlation a frame.
        recipe = TRACKER_REGISTRY["promixtrack"]
        zoo = FrameRecorder(recipe.build(device=dev))
        reset_launches(*counters)
        t0 = time.perf_counter()
        states = session("mask", VOT_FRAMES, trk=zoo, dtype=recipe.composition)
        elapsed = time.perf_counter() - t0
        launches = launch_counts(counters)
        nominations = zoo.tracker.nominations
        want = {"crop_resize_normalized": 2 * VOT_FRAMES + nominations,
                "depthwise_xcorr": VOT_FRAMES - 1}
        ok = len(states) == VOT_FRAMES and all(
            isinstance(st, Mask) and (st.x, st.y) == (0, 0) and st.mask.shape == (H, W)
            for st in states[1:])
        log("vot", protocol="mask", tracker="promixtrack", dtype="f32",
            composition=recipe.composition, ar_input_size=AR_INPUT_SIZE, frames=VOT_FRAMES,
            frame=f"{W}x{H}", states=len(states), states_ok=ok, nominations=nominations,
            ring_updates=zoo.tracker.ring_updates, launches=launches, expected=want,
            ms_per_frame=elapsed / VOT_FRAMES * 1e3, card=card_line())
        if not ok or launches != want:
            raise AssertionError(f"vot promixtrack mask: states ok {ok}, launches {launches} "
                                 f"(want {want})")
        for name, k in launches.items():
            counted[name] += k
        del zoo
        torch.cuda.empty_cache()

        dimp_vot_session(dev, session, counters)

        # one refine on the card against the same model on the CPU
        frame = cv2.cvtColor(cv2.imread(colors[1]), cv2.COLOR_BGR2RGB)
        box = [x + 2.0, y + 1.0, w + 3.0, h - 2.0]
        cpu_ref = refiner_factory("cpu")()
        cpu_ref.model.load_state_dict(refiner.model.state_dict())
        for seg in (refiner, cpu_ref):
            seg.initialize(cv2.cvtColor(cv2.imread(colors[0]), cv2.COLOR_BGR2RGB), [x, y, w, h])
        (bg, pg), (bc, pc) = refiner.refine(frame, box), cpu_ref.refine(frame, box)
        diff = dict(prob_max_abs_diff=float(np.abs(pg - pc).max()),
                    box_max_abs_diff_px=float(np.abs(np.subtract(bg, bc)).max()),
                    binary_pixels_differ=int(((pg > 0.5) != (pc > 0.5)).sum()),
                    prob_bar=AR_PROB_BAR)
        log("vot_refine_card_vs_cpu", **diff)
        if not diff["prob_max_abs_diff"] <= AR_PROB_BAR:
            raise AssertionError(f"Alpha-Refine card vs CPU: {diff}")
    return counted


def dimp_vot_session(dev, session, counters) -> None:
    """Phase 8's det_dimp50_max session: DeT's VOT RGB-D entry, rectangle
    protocol, DIMP_VOT_FRAMES frames after a 3-frame warm-up session; no
    kernel of the port runs on its path. `session(protocol, n, timings,
    trk, dtype)` is vot_path's TraX session."""
    H, W = VOT_HW
    recipe = TRACKER_REGISTRY["det_dimp50_max"]
    session("rectangle", 3, trk=recipe.build(device=dev), dtype=recipe.composition)
    zoo = recipe.build(device=dev)
    reset_launches(*counters)
    timings = {}
    t0 = time.perf_counter()
    states = session("rectangle", DIMP_VOT_FRAMES, timings, trk=zoo, dtype=recipe.composition)
    elapsed = time.perf_counter() - t0
    launches = launch_counts(counters)
    want = dict.fromkeys(launches, 0)
    ok = len(states) == DIMP_VOT_FRAMES and all(
        isinstance(st, Rectangle) and np.isfinite(list(st)).all() for st in states[1:])
    frames = timings["frames"]
    log("vot", protocol="rectangle", tracker="det_dimp50_max", dtype="f32",
        composition=recipe.composition, frames=DIMP_VOT_FRAMES, frame=f"{W}x{H}",
        states=len(states), states_ok=ok, launches=launches, expected=want,
        ms_per_frame=elapsed / DIMP_VOT_FRAMES * 1e3,
        ms_per_frame_split={k: timings[k] / frames * 1e3
                            for k in ("read_compose", "track", "refine", "encode")},
        flags=zoo.flags, optimizer_iters=zoo.optimizer_iters, card=card_line())
    if not ok or launches != want:
        raise AssertionError(f"vot det_dimp50_max: states ok {ok}, launches {launches}")


OPE_PASSES = 2                                       # timed passes per wire, best kept
OPE_IOU_BAR = 0.6                                    # yuv420 wire vs rgb_index wire
OPE_KERNELS = {"attention": (ATTENTION_KERNELS, 9), "gemm": ((GEMM_KERNEL,), GEMM_CALLS_PER_STEP),
               "layernorm": ((LAYERNORM_KERNEL,), 21), "crop": ((CROP_KERNEL,), 1)}
OPE_COUNTERS = (attn_block_fused, mlp_block_fused, crop_resize_normalized)


def ope_fixture(root: str, n_seqs: int = OPE_SEQS, n_frames: int = OPE_FRAMES) -> None:
    """n_seqs DepthTrack-layout sequences of n_frames frames under root:
    color/*.jpg (cv2's default quality and 4:2:0) and 16-bit depth/*.png
    made from data/synthetic.py's frames (RGB from the first triplet; depth
    a seeded base, nearer where the target's aux triplet is bright), and a
    groundtruth.txt. Written by 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    H, W = OPE_HW
    jobs = []
    for i in range(n_seqs):
        rng = np.random.RandomState(100 + i)
        box0 = (rng.uniform(60, W - 160), rng.uniform(50, H - 120),
                rng.uniform(48, 96), rng.uniform(40, 72))
        frames, gt = make_synthetic_sequence(n_frames=n_frames, height=H, width=W,
                                             seed=100 + i, box0=box0,
                                             velocity=tuple(rng.uniform(-4, 4, 2)))
        base = (2000 + 3000 * np.linspace(0, 1, H)[:, None]
                + rng.randint(0, 300, (H, W))).astype(np.int32)
        seq = os.path.join(root, f"seq{i:02d}")
        for sub in ("color", "depth"):
            os.makedirs(os.path.join(seq, sub))
        np.savetxt(os.path.join(seq, "groundtruth.txt"), gt, delimiter=",", fmt="%.4f")
        for t in range(n_frames):
            depth = (base - 6 * frames[t, :, :, 3].astype(np.int32)).clip(0, 65535)
            jobs.append((os.path.join(seq, "color", f"{t:08d}.jpg"),
                         cv2.cvtColor(frames[t, :, :, :3], cv2.COLOR_RGB2BGR)))
            jobs.append((os.path.join(seq, "depth", f"{t:08d}.png"), depth.astype(np.uint16)))
    with ThreadPoolExecutor(8) as pool:
        if not all(pool.map(lambda job: cv2.imwrite(*job), jobs)):
            raise IOError("could not write the OPE fixture")


def ope_counts() -> dict:
    return launch_counts(OPE_COUNTERS)


def profile_pass(fn, dev, kernels=OPE_KERNELS) -> tuple[dict, float, float]:
    """One call of fn() under torch.profiler: the calls of the kernels of
    `kernels` (name -> (kernel names, calls per step)), the device ms
    (every CUDA row), the wall ms. The window's
    warm-up step holds one tiny kernel, and the window opens with
    `window_head`, so no kernel of fn() is among the window's first."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.extend(p.key_averages())) as prof:
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
        prof.step()
        window_head()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    rows = device_rows(kept)
    counts = {k: sum(e.count for e in rows if any(n in e.key for n in names))
              for k, (names, _) in kernels.items()}
    return counts, sum(e.self_device_time_total for e in rows) / 1e3, wall


class SplitTracker(BatchedViPTTracker):
    """A BatchedViPTTracker that adds each streamed step's wall time, in
    three parts, to `split`: the wait since the previous step returned
    ('decode_wait': the decode thread's join; before the first step, the
    first frame's decode after the staging buffers), upload + compose
    ('upload_compose', up to a synchronisation after the compose) and
    replay + host read of the boxes ('replay_read'); and 'steps'. The
    synchronisation adds no device work but idles the card between
    compose and replay, so whole-pass times come from BatchedViPTTracker."""

    def __init__(self, *args, split: dict, **kwargs):
        super().__init__(*args, **kwargs)
        self.split = split
        self._last = time.perf_counter()

    def host_buffer(self, shape: tuple) -> np.ndarray:
        buf = super().host_buffer(shape)
        self._last = time.perf_counter()
        return buf

    def _composed_step(self, compose, *planes):
        t0 = time.perf_counter()
        frames = compose(*self._upload(*planes), self._lut)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        out = self._step(frames)
        t2 = time.perf_counter()
        for k, v in (("decode_wait", t0 - self._last), ("upload_compose", t1 - t0),
                     ("replay_read", t2 - t1), ("steps", 1)):
            self.split[k] = self.split.get(k, 0) + v
        self._last = t2
        return out


def ope_path(dev, cfg, rt) -> dict:
    """Phase 9: the streamed OPE path at full width. Returns the launches
    of each kernel counted in it."""
    from mmtrack_torch.data import native_io
    from mmtrack_torch.eval.batched_ope import run_dataset_batched
    from mmtrack_torch.eval.datasets import list_sequences, load_sequence
    from mmtrack_torch.eval.analysis import analyze_fscore, analyze_ope
    from mmtrack_torch.eval.metrics import iou_xywh
    from mmtrack_torch.eval.ope import run_sequence
    from mmtrack_torch.ops.compose import yuv420_to_rgb_device

    H, W = OPE_HW
    steps = OPE_FRAMES - 1
    n_frames = OPE_SEQS * steps
    counted = dict.fromkeys(ope_counts(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "DepthTrack")
        t0 = time.perf_counter()
        ope_fixture(root)
        write_s = time.perf_counter() - t0
        seqs = [load_sequence(d, "DepthTrack") for d in list_sequences(root, "DepthTrack")]
        decoder, load_error = native_io.decoder(), native_io.load_error()
        log("ope_env", decoder=decoder, decoder_error=load_error, cpu_count=os.cpu_count(),
            sequences=len(seqs), frames=OPE_FRAMES, frame=f"{W}x{H}", fixture_write_s=write_s)

        compose_s = [0.0]

        def host_composed(s):
            def load(t):
                c0 = time.perf_counter()
                frame = get_x_frame(s.rgb_frames[t], s.x_frames[t], s.dtype, s.depth_clip)
                compose_s[0] += time.perf_counter() - c0
                return frame
            return load

        loaders = {s.name: host_composed(s) for s in seqs}
        model = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0)
        scan = make_track_scan(rt, model, dev)
        runs = [0]

        def run(wire: str, split=None):
            """One pass over the fixture on `wire` (of SplitTracker when
            `split` is a dict); (results, seconds, results root)."""
            os.environ.pop("MMTRACK_STREAM", None)
            if wire == "yuv420":
                os.environ["MMTRACK_STREAM"] = "yuv420"
            runs[0] += 1
            res_root = os.path.join(tmp, f"results_{runs[0]}")
            t0 = time.perf_counter()
            try:
                out = run_dataset_batched(
                    lambda: (BatchedViPTTracker(model, dev, rt, scan=scan) if split is None
                             else SplitTracker(model, dev, rt, scan=scan, split=split)),
                    seqs, res_root, "DepthTrack", "phase9", batch_size=OPE_SEQS,
                    loaders=loaders if wire == "frames" else None, verbose=False)
            finally:
                os.environ.pop("MMTRACK_STREAM", None)
            seconds = time.perf_counter() - t0
            ran = {r["wire"] for r in out}
            if ran != {wire} or len(out) != OPE_SEQS:
                raise AssertionError(f"ope: asked for the {wire} wire, ran {ran} "
                                     f"({len(out)} results)")
            return out, seconds, res_root

        wires = ["frames", "rgb_index"] + (["yuv420"] if decoder == "native" else [])
        reset_launches(*OPE_COUNTERS)
        results, roots, report = {}, {}, {}
        for wire in wires:
            passes = []
            for _ in range(1 if wire == "frames" else OPE_PASSES):
                compose_s[0] = 0.0
                out, seconds, res_root = run(wire)
                passes.append((seconds, compose_s[0], out, res_root))
            best = min(passes, key=lambda p: p[0])
            for (_, _, out, _) in passes[1:]:
                for a, b in zip(passes[0][2], out):
                    if not (np.array_equal(a["boxes"], b["boxes"])
                            and np.array_equal(a["confidences"], b["confidences"])):
                        raise AssertionError(f"ope {wire}: two passes differ")
            results[wire], roots[wire] = passes[0][2], passes[0][3]
            report[wire] = dict(frames_per_s=n_frames / best[0], best_pass_s=best[0],
                                pass_s=[p[0] for p in passes], ms_per_step=best[0] / steps * 1e3)
            if wire == "frames":
                report[wire]["split_ms_per_step"] = {
                    "host_decode_compose": best[1] / steps * 1e3,
                    "rest": (best[0] - best[1]) / steps * 1e3}
                continue
            # one more pass, split and profiled: the split's synchronisation
            # after the compose adds no device work
            want = {k: n * steps + (k == "crop") for k, (_, n) in OPE_KERNELS.items()}
            for attempt in range(3):   # a window now and then loses a kernel's event
                split = {}
                kernels, dev_ms, wall_ms = profile_pass(lambda: run(wire, split), dev)
                if kernels == want:
                    break
            report[wire].update(
                split_ms_per_step={k: split[k] / split["steps"] * 1e3
                                   for k in ("decode_wait", "upload_compose", "replay_read")},
                kernels_in_profiled_pass=kernels, kernels_expected=want,
                device_ms_per_step=dev_ms / steps, idle_share=1 - dev_ms / wall_ms,
                profiled_pass_wall_ms=wall_ms)
            if kernels != want:
                raise AssertionError(f"ope {wire}: kernels in a profiled pass {kernels}, "
                                     f"want {want}")
        launches = ope_counts()
        n_runs = runs[0]
        capture = SCAN_WARMUP_STEPS + 1
        expected = {"attn_block_fused": 9 * capture, "mlp_block_fused": 12 * capture,
                    "crop_resize_normalized": capture + n_runs}

        exact = all(np.array_equal(a["boxes"], b["boxes"])
                    and np.array_equal(a["confidences"], b["confidences"])
                    for a, b in zip(results["frames"], results["rgb_index"]))
        boxes = np.stack([r["boxes"] for r in results["rgb_index"]])
        inside = bool(np.isfinite(boxes).all() and (boxes[..., :2] >= 0).all()
                      and (boxes[..., 0] + boxes[..., 2] <= W + 1e-3).all()
                      and (boxes[..., 1] + boxes[..., 3] <= H + 1e-3).all())
        ious = None
        if "yuv420" in results:
            ious = np.concatenate([iou_xywh(a["boxes"][1:], b["boxes"][1:])
                                   for a, b in zip(results["rgb_index"], results["yuv420"])])

        # the RGB planes each streamed wire uploads, against cv2's decode
        def tally(acc, got, ref):
            d = np.abs(got.astype(int) - ref).max(-1)
            acc["max_lsb"] = max(acc["max_lsb"], int(d.max()))
            acc["pixels_differ"] += int((d > 0).sum())
            acc["frames"] += 1

        rgb_diff = {"max_lsb": 0, "pixels_differ": 0, "frames": 0}
        yuv_diff = dict(rgb_diff) if ious is not None else None
        for s in seqs:
            for t in (1, steps // 2, steps):
                ref = cv2.cvtColor(cv2.imread(s.rgb_frames[t]), cv2.COLOR_BGR2RGB).astype(int)
                rgb, idx = np.zeros((H, W, 3), np.uint8), np.zeros((H, W), np.uint8)
                native_io.decode_pair_rgb_index(s.rgb_frames[t], s.x_frames[t], rgb, idx)
                tally(rgb_diff, rgb, ref)
                if yuv_diff is not None:
                    y, cb, cr = (np.zeros((H, W), np.uint8), np.zeros((H // 2, W // 2), np.uint8),
                                 np.zeros((H // 2, W // 2), np.uint8))
                    native_io.decode_pair_yuv_index(s.rgb_frames[t], s.x_frames[t], y, cb, cr,
                                                    idx)
                    planes = (torch.from_numpy(p).to(dev) for p in (y, cb, cr))
                    tally(yuv_diff, yuv420_to_rgb_device(*planes).cpu().numpy(), ref)

        log("ope", config="deep_rgbd", dtype="bf16", B=OPE_SEQS, frames=OPE_FRAMES,
            frame=f"{W}x{H}", decoder=decoder, wires=report,
            rgb_index_bit_equal_to_frames=exact, boxes_inside=inside,
            yuv_iou_vs_rgb_index=None if ious is None else
            {"min": float(ious.min()), "mean": float(ious.mean()), "bar": OPE_IOU_BAR},
            yuv_skipped=None if ious is not None else f"decoder {decoder}: {load_error}",
            rgb_planes_vs_cv2=rgb_diff, yuv_planes_vs_cv2=yuv_diff,
            launches=launches, expected=expected, card=card_line())
        if not exact or not inside:
            raise AssertionError(f"ope: rgb_index bit-equal to frames {exact}, "
                                 f"boxes inside {inside}")
        if ious is not None and not ious.min() > OPE_IOU_BAR:
            raise AssertionError(f"ope: yuv420 IoU vs rgb_index {ious.min()}")
        if launches != expected:
            raise AssertionError(f"ope launches {launches}, want {expected}")
        for k, n in launches.items():
            counted[k] += n

        # the entry, as a user runs it, in its own process
        entry_root = os.path.join(tmp, "entry")
        env = {k: v for k, v in os.environ.items() if k != "MMTRACK_STREAM"}
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        # deep_rgbd with bf16 compute: the precision comes from the config
        entry_cfg = os.path.join(tmp, "deep_rgbd.json")
        with open(entry_cfg, "w") as f:
            json.dump({"TRAIN": {"AMP": True}}, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mmtrack_torch.eval.run_ope",
                               "--dataset", "DepthTrack", "--dataset_root", root,
                               "--config", entry_cfg, "--batched", str(OPE_SEQS),
                               "--analyze", "--results_root", entry_root],
                              cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        entry_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"ope entry exited {proc.returncode}: {proc.stderr[-3000:]}")
        run_dir = os.path.join(entry_root, "DepthTrack", "deep_rgbd")
        written = sorted(f for f in os.listdir(run_dir) if f.endswith(".txt"))
        with open(os.path.join(entry_root, "DepthTrack", "deep_rgbd_report.json")) as f:
            entry_report = json.load(f)
        ope_in = analyze_ope(seqs, roots["rgb_index"], "DepthTrack", "phase9")["overall"]
        fs_in = analyze_fscore(seqs, roots["rgb_index"], "DepthTrack", "phase9")
        keys = ("success_auc", "precision_20px", "norm_precision_auc")
        same = (all(entry_report["ope"][k] == ope_in[k] for k in keys)
                and entry_report["fscore"] == fs_in)
        box_diff = max(float(np.abs(
            np.loadtxt(os.path.join(run_dir, f"{s.name}.txt"), delimiter=",")
            - np.loadtxt(os.path.join(roots["rgb_index"], "DepthTrack", "phase9",
                                      f"{s.name}.txt"), delimiter=",")).max()) for s in seqs)
        log("ope_entry", seconds=entry_s, results=len(written), stdout=proc.stdout.splitlines(),
            report_ope={k: entry_report["ope"][k] for k in keys},
            in_process_ope={k: ope_in[k] for k in keys}, report_equal=same,
            boxes_max_abs_diff_vs_rgb_index_files_px=box_diff)
        if len(written) != OPE_SEQS or not same:
            raise AssertionError(f"ope entry: {len(written)} result files, report equal {same}")

        # the bit-exact host crop against the crop kernel, one sequence at
        # f32, on frames composed once beforehand (ms per frame leaves the
        # decode out)
        model32 = build_viptrack(cfg, dtype=torch.float32, device=dev, seed=0)
        seq = seqs[0]
        frames = [get_x_frame(seq.rgb_frames[t], seq.x_frames[t], seq.dtype, seq.depth_clip)
                  for t in range(OPE_FRAMES)]
        out = {}
        for name, host in (("host_crop", True), ("device_crop", False)):
            reset_launches(crop_resize_normalized)
            res = run_sequence(ViPTTracker(model32, dev, rt, host_preproc=host), seq,
                               frame_loader=frames.__getitem__)
            out[name] = (res, launch_counts([crop_resize_normalized])["crop_resize_normalized"])
        ious = iou_xywh(out["host_crop"][0]["boxes"][1:], out["device_crop"][0]["boxes"][1:])
        crops = {k: n for k, (_, n) in out.items()}
        log("ope_host_crop", dtype="f32", frames=OPE_FRAMES, frame=f"{W}x{H}",
            ms_per_frame={k: 1e3 / r["fps"] for k, (r, _) in out.items()},
            iou_vs_device_crop={"min": float(ious.min()), "mean": float(ious.mean())},
            crop_launches=crops, card=card_line())
        if crops != {"host_crop": 0, "device_crop": OPE_FRAMES} or not all(
                np.isfinite(r["boxes"]).all() for r, _ in out.values()):
            raise AssertionError(f"ope host crop: crop launches {crops}")
        counted["crop_resize_normalized"] += OPE_FRAMES
    return counted


class FrameRecorder:
    """A tracker behind its own API that times the initialize (to its
    device work's end) and each track() (the zoo's trackers read their box
    on the host, so a call ends when its device work does) and counts the
    template refreshes it reports."""

    def __init__(self, tracker):
        self.tracker, self.updates, self.ms, self.init_ms = tracker, 0, [], None

    def initialize(self, image, info):
        t0 = time.perf_counter()
        self.tracker.initialize(image, info)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.init_ms = (time.perf_counter() - t0) * 1e3

    def track(self, image, info=None):
        t0 = time.perf_counter()
        out = self.tracker.track(image, info)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.updates += int(out.get("update_flag", False))
        return out


# frames of the one sequence each zoo recipe runs over (phases 10, 12-15):
# 11 frames of a phase-9 fixture, which keeps the 11th frame's card-vs-CPU
# checks and 7 frames after ZOO_WARMUP
ZOO_FRAMES = 11
ZOO = ("ostrack", "ostrack_online", "stark_s", "stark_st", "spt", "siamfc",
       "mixformer_rgbd", "samf", "promixtrack")
# run_ope --tracker in its own process (eco in phase 12)
ZOO_ENTRIES = ("spt", "samf", "det_dimp50_max", "eco")
# the DiMP family (PR 10): no kernel of the port runs on its path
DIMP_ZOO = ("dimp50", "det_dimp50_max", "det_dimp50_mean", "det_dimp50_mul",
            "det_dimp50_weightedsum", "det_dimp50_mc", "mfdimp", "prdimp50")
DIMP_PROFILED = ("det_dimp50_max", "prdimp50")
DIMP_SYNC_FRAMES = 4                # frames under torch.cuda's sync debug mode
DIMP_VOT_FRAMES = 10
DIMP_BOX_BAR = 1e-3                 # det_dimp50_max card vs CPU: box, px
DIMP_SCORE_BAR = 1e-4               # and score
KERNEL_COUNTERS = (attn_block_fused, mlp_block_fused, crop_resize_normalized, flash_mhsa_qkv,
                   depthwise_xcorr)
ZOO_WARMUP = 3                      # frames left out of the median ms per frame
# trackers whose box is not clipped to the frame: zoo_boxes_ok checks their centre
UNCLIPPED = ("siamfc", "atom", "det_atom_max", "det_atom_mean", "det_atom_mc", "keep_track",
             "kys", "stm")
# OSTrack-online's attention half-blocks per frame: blocks 0-2 at L = 464
# and 4-5 at 344 take the streaming branch, 7-8 at 260 and 10-11 at 202 the
# resident one (the CE blocks 3, 6, 9 run unfused)
OO_ATTENTION = {k: ((k,), n) for k, n in (("attention_streaming_kernel", 5),
                                          ("attention_resident_kernel", 4))}
OO_PROFILE_FRAMES = 3


def zoo_boxes_ok(name: str, boxes: np.ndarray, H: int, W: int) -> bool:
    """Every box finite and inside the H x W frame; SiamFC's protocol does
    not clip its box (siamfc_tracker.py:125-146), nor do ATOM's, KeepTrack's
    and KYS's after the IoU refinement (atom_tracker.py:430-438, the DiMP
    step's clamp comes before it), so their centres."""
    if not np.isfinite(boxes).all():
        return False
    if name in UNCLIPPED:
        cx, cy = boxes[:, 0] + boxes[:, 2] / 2, boxes[:, 1] + boxes[:, 3] / 2
        return bool(((cx >= 0) & (cx <= W) & (cy >= 0) & (cy <= H)).all())
    return bool((boxes[:, :2] >= 0).all() and (boxes[:, 0] + boxes[:, 2] <= W + 1e-3).all()
                and (boxes[:, 1] + boxes[:, 3] <= H + 1e-3).all())


def oo_forward(dev, model, plain, templates, searches, rt) -> None:
    """OSTrack-online's dual-template forward at bf16 with the kernels and
    on the plain versions: without CE within phase 4's bars, with CE (the
    path) the kept-set agreement and map differences printed."""
    mask = generate_ctr_mask(rt.template_size // rt.stride, rt.ce_template_range, dev)

    def run(m, keep):
        kept = {}
        hooks = [m.backbone.blocks[i].register_forward_hook(
            lambda mod, inp, out, i=i: kept.__setitem__(i, out[2].sort(1).values))
            for i in rt.ce_loc]
        with torch.inference_mode():
            out = m(templates, searches, mask, keep)
        for h in hooks:
            h.remove()
        return out, kept

    def diffs(a, b):
        d = {k: (a[k] - b[k]).abs().max().item() for k in ("score_map", "size_map")}
        d["offset_map_rel"] = ((a["offset_map"] - b["offset_map"]).abs().max()
                               / b["offset_map"].abs().max()).item()
        return d

    (ok_, _), (op, _) = run(model, None), run(plain, None)
    no_ce = diffs(ok_, op)
    (ck, kk), (cp, kp) = run(model, rt.ce_keep_lens), run(plain, rt.ce_keep_lens)
    log("zoo_oo_forward", dtype="bf16", B=OO_B, tokens=OO_TOKENS[0], max_diff_without_ce=no_ce,
        map_bar=MAP_BAR, offset_rel_bar=OFFSET_REL_BAR, max_diff_with_ce=diffs(ck, cp),
        ce_sets_identical=[int((kk[i] == kp[i]).all(1).sum()) for i in rt.ce_loc], of=OO_B)
    if (no_ce["score_map"] > MAP_BAR or no_ce["size_map"] > MAP_BAR
            or no_ce["offset_map_rel"] > OFFSET_REL_BAR):
        raise AssertionError(f"OSTrack-online forward: kernels vs plain beyond bar: {no_ce}")


def zoo_path(dev) -> dict:
    """Phase 10: the zoo's six recipes, OSTrack-online at bf16 and the spt
    entry. Returns the launches of each kernel counted in it."""
    from mmtrack_torch.eval.datasets import list_sequences, load_sequence
    from mmtrack_torch.eval.ope import result_path, run_sequence, save_result

    H, W = OPE_HW
    counted = dict.fromkeys(ope_counts(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "DepthTrack")
        ope_fixture(root, n_seqs=1, n_frames=ZOO_FRAMES)
        seq_dir = list_sequences(root, "DepthTrack")[0]
        res_in = os.path.join(tmp, "in_process")
        for name in ZOO:
            recipe = TRACKER_REGISTRY[name]
            seq = load_sequence(seq_dir, "DepthTrack")
            seq.dtype = recipe.composition
            tracker = FrameRecorder(recipe.build(device=dev))
            reset_launches(*OPE_COUNTERS)
            res = run_sequence(tracker, seq)
            launches = ope_counts()
            extra = {}
            if recipe.family == "mixformer":
                # the template, one search crop per scale a frame, one per nomination
                inner = tracker.tracker
                crops = (1 + (ZOO_FRAMES - 1) * len(inner.rt.scale_factors)
                         + inner.nominations)
                extra = dict(scales=list(inner.rt.scale_factors), nominations=inner.nominations,
                             ring_updates=inner.ring_updates, n_online=inner.state["n_online"])
                # one more frame (the last again) under the profiler, after the count
                last = get_x_frame(seq.rgb_frames[-1], seq.x_frames[-1], seq.dtype,
                                   seq.depth_clip)
                rows, wall_s = profile_window(lambda: inner.track(last), 1)
                dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
                extra.update(profiled_frame_device_ms=dev_ms,
                             profiled_frame_wall_ms=wall_s * 1e3,
                             device_idle_share=1.0 - dev_ms / (wall_s * 1e3),
                             profiled_frame_kernels=sum(e.count for e in rows),
                             top_kernels=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                                          for e in rows[:6]])
            else:
                crops = 0 if name == "siamfc" else ZOO_FRAMES + tracker.updates
            want = {"attn_block_fused": 0, "mlp_block_fused": 0,   # f32: the plain blocks
                    "crop_resize_normalized": crops}
            ok = zoo_boxes_ok(name, res["boxes"], H, W)
            log("zoo", tracker=name, family=recipe.family, modality=recipe.modality,
                composition=recipe.composition, dtype="f32", frames=ZOO_FRAMES,
                frame=f"{W}x{H}", boxes_ok=ok, template_updates=tracker.updates,
                launches=launches, expected=want,
                median_ms_per_frame=float(np.median(tracker.ms[ZOO_WARMUP:])),
                first_frame_ms=tracker.ms[0], **extra, card=card_line())
            if not ok or launches != want:
                raise AssertionError(f"zoo {name}: boxes ok {ok}, launches {launches} "
                                     f"(want {want})")
            for k, n in launches.items():
                counted[k] += n
            if name == "mixformer_rgbd":
                mixformer_card_vs_cpu(dev, tracker.tracker.model)
            if name in ZOO_ENTRIES:
                save_result(result_path(res_in, "DepthTrack", name, seq.name), res,
                            fmt=seq.save_fmt, delimiter=seq.save_delimiter,
                            time_style=seq.time_style)
            del tracker
            torch.cuda.empty_cache()
        dimp_path(dev, seq_dir, res_in)

        # OSTrack-online at bf16 through build_ostrack's dtype: the half-blocks
        # at B=2 and L = 464 / 344 / 260 / 202
        seq = load_sequence(seq_dir, "DepthTrack")
        seq.dtype = "color"
        frames = [get_x_frame(seq.rgb_frames[t], seq.x_frames[t], "color", seq.depth_clip)
                  for t in range(ZOO_FRAMES)]
        rt = OSTrackOnlineRuntime()
        model = build_ostrack(template_size=128, search_size=320, dtype=torch.bfloat16,
                              device=dev, seed=0)
        plain = build_ostrack(template_size=128, search_size=320, dtype=torch.bfloat16,
                              device=dev, seed=0, use_kernels=False)
        cls = init_vipt_weights(ScoreTransformer(d_model=768, n_layers=rt.cls_attn_layers,
                                                 n_mlp_layers=rt.cls_mlp_layers), 1)
        mean, std = torch.from_numpy(MEAN_6CH[:3]).to(dev), torch.from_numpy(STD_6CH[:3]).to(dev)
        box = torch.tensor(seq.gt[:1], dtype=torch.float32, device=dev)
        f0, f1 = (torch.from_numpy(frames[t][None]).to(dev) for t in (0, 1))
        with torch.inference_mode():
            templates = torch.cat([crop_resize_normalized_plain(f, box, rt.template_factor,
                                                                rt.template_size, mean, std)[0]
                                   for f in (f0, f1)])
            search = crop_resize_normalized_plain(f1, box, rt.search_factor, rt.search_size,
                                                  mean, std)[0]
        oo_forward(dev, model, plain, templates, search.expand(OO_B, -1, -1, -1), rt)
        del plain
        tracker = FrameRecorder(OSTrackOnlineTracker(model, cls, dev, rt))
        run_sequence(tracker, seq, frame_loader=frames.__getitem__)   # warm-up pass
        reset_launches(*OPE_COUNTERS)
        tracker.updates, tracker.ms = 0, []
        res = run_sequence(tracker, seq, frame_loader=frames.__getitem__)
        launches = ope_counts()
        steps = ZOO_FRAMES - 1
        want = {"attn_block_fused": 9 * steps, "mlp_block_fused": 12 * steps,
                "crop_resize_normalized": ZOO_FRAMES + tracker.updates}
        # the branches over OO_PROFILE_FRAMES profiled frames; a window now
        # and then loses an event, so up to three windows
        want_branches = {k: n * OO_PROFILE_FRAMES for k, (_, n) in OO_ATTENTION.items()}
        for _ in range(3):
            branches, dev_ms, _ = profile_pass(
                lambda: [tracker.track(frames[-1]) for _ in range(OO_PROFILE_FRAMES)], dev,
                OO_ATTENTION)
            if branches == want_branches:
                break
        ok = zoo_boxes_ok("ostrack_online", res["boxes"], H, W)
        log("zoo_oo_bf16", tracker="ostrack_online", dtype="bf16", frames=ZOO_FRAMES,
            frame=f"{W}x{H}", boxes_ok=ok, template_updates=tracker.updates,
            launches=launches, expected=want, profiled_frames=OO_PROFILE_FRAMES,
            attention_branches=branches, expected_branches=want_branches,
            median_ms_per_frame=float(np.median(tracker.ms[ZOO_WARMUP:])),
            device_ms_per_frame=dev_ms / OO_PROFILE_FRAMES, card=card_line())
        if not ok or launches != want or branches != want_branches:
            raise AssertionError(f"zoo ostrack_online bf16: boxes ok {ok}, launches {launches} "
                                 f"(want {want}), attention branches {branches}")
        for k, n in launches.items():
            counted[k] += n
        del model, tracker
        torch.cuda.empty_cache()

        # the device rgbcolormap compose of the sequence's frames, bit-equal
        # to the host composition that mixformer_rgbd and samf read
        compose_check(dev, load_sequence(seq_dir, "DepthTrack"))

        # the entries, as a user runs them, each in its own process (after phase 15)
        defer_entries([n for n in ZOO_ENTRIES if n in ZOO + DIMP_ZOO], root, seq_dir, res_in)
    return counted


# the run_ope entries of phases 10 and 12-15, (names, root, sequence dir,
# in-process results, their directory, dataset), run by zoo_entries_path
DEFERRED_ENTRIES: list = []


def defer_entries(names, root: str, seq_dir: str, res_in: str,
                  dataset: str = "DepthTrack") -> None:
    """Queue `run_ope --tracker <name>` for each name over a copy of the
    `dataset` layout at root and of the in-process results under res_in;
    zoo_entries_path runs and checks the queue."""
    keep = tempfile.mkdtemp()
    data = shutil.copytree(root, os.path.join(keep, "data"))
    DEFERRED_ENTRIES.append((names, data, os.path.join(data, os.path.relpath(seq_dir, root)),
                             shutil.copytree(res_in, os.path.join(keep, "in_process")), keep,
                             dataset))


def start_zoo_entries() -> dict:
    """The entries of phases 10 and 12-15, started side by side, each
    `python -m mmtrack_torch.eval.run_ope --tracker <name> --analyze` in its
    own process over its phase's sequence."""
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    started = [(name, subprocess.Popen(
        [sys.executable, "-m", "mmtrack_torch.eval.run_ope", "--tracker", name, "--dataset",
         dataset, "--dataset_root", root, "--analyze", "--results_root",
         os.path.join(keep, f"entry_{name}")], cwd=keep, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), seq_dir, res_in, keep, dataset)
        for names, root, seq_dir, res_in, keep, dataset in DEFERRED_ENTRIES for name in names]
    return {"started": started, "t0": t0}


def zoo_entries_path(entries: dict) -> None:
    """The entries start_zoo_entries started (beside phase 18): each must
    exit 0 with a result file and a report equal to the analysis of its
    phase's in-process results."""
    from mmtrack_torch.eval.datasets import load_sequence

    started, t0 = entries["started"], entries["t0"]
    try:
        for name, proc, seq_dir, res_in, keep, dataset in started:
            check_entry(proc, name, dataset, [load_sequence(seq_dir, dataset)], res_in, keep, t0)
    finally:
        stop_zoo_entries(entries)
    log("zoo_entries_phase", seconds=time.perf_counter() - t0)


def stop_zoo_entries(entries: dict) -> None:
    """End the entries still running and remove their copies."""
    for _, proc, *_ in entries.get("started", ()):
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    for entry in DEFERRED_ENTRIES:
        shutil.rmtree(entry[4], ignore_errors=True)
    DEFERRED_ENTRIES.clear()


def check_entry(proc, name: str, dataset: str, seqs, res_in: str, tmp: str, t0: float) -> None:
    """Wait for one run_ope entry of zoo_entries_path and hold its files."""
    from mmtrack_torch.eval.analysis import analyze_fscore, analyze_ope
    from mmtrack_torch.eval.ope import result_path

    stdout, stderr = proc.communicate(timeout=600)
    entry_s = time.perf_counter() - t0
    entry_root = os.path.join(tmp, f"entry_{name}")
    if proc.returncode != 0:
        raise AssertionError(f"{name} entry exited {proc.returncode}: {stderr[-3000:]}")
    path = result_path(entry_root, dataset, name, seqs[0].name)
    written = os.path.exists(path)
    with open(os.path.join(entry_root, dataset, f"{name}_report.json")) as f:
        report = json.load(f)
    ope_in = analyze_ope(seqs, res_in, dataset, name)["overall"]
    want = {"ope": {k: v for k, v in ope_in.items() if np.isscalar(v)},
            "fscore": analyze_fscore(seqs, res_in, dataset, name)}
    same = report == json.loads(json.dumps(want))
    box_diff = float(np.abs(
        np.loadtxt(path, delimiter=seqs[0].save_delimiter)
        - np.loadtxt(result_path(res_in, dataset, name, seqs[0].name),
                     delimiter=seqs[0].save_delimiter)).max())
    log("zoo_entry", tracker=name, seconds=entry_s, result_file=written,
        stdout=stdout.splitlines()[-6:], report_equal=same,
        boxes_max_abs_diff_vs_in_process_px=box_diff)
    if not written or not same:
        raise AssertionError(f"{name} entry: result file {written}, report equal "
                             f"{same}: {report} vs {want}")


def host_sync_sites(fn) -> list:
    """The synchronizing CUDA calls fn() makes (a blocking copy either way,
    `.item()`, a stream sync), as torch.cuda's sync debug mode reports
    them: the Python file:line of each."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def host_syncs(fn) -> int:
    """The number of `host_sync_sites` of fn()."""
    return len(host_sync_sites(fn))


def thermal_standin(depth_path: str) -> np.ndarray:
    """An 8-bit thermal stand-in of a depth frame, nearer being warmer
    (255 - depth / 40, clipped)."""
    depth = cv2.imread(depth_path, -1).astype(np.float32)
    return (255.0 - np.clip(depth / 40.0, 0.0, 255.0)).astype(np.uint8)


def thermal_frames(seq) -> list:
    """rgbrgb frames for an RGB-T recipe from a DepthTrack sequence: its
    colour beside the thermal stand-in of its depth."""
    return [compose_x(cv2.cvtColor(cv2.imread(c), cv2.COLOR_BGR2RGB), thermal_standin(d),
                      "rgbrgb") for c, d in zip(seq.rgb_frames, seq.x_frames)]


def dimp_path(dev, seq_dir: str, res_in: str) -> None:
    """Phase 10's DiMP recipes from the registry at f32 on seeded weights
    over the sequence: boxes, the median ms per frame after ZOO_WARMUP
    frames, host syncs per frame, the localisation flags, the filter
    iterations run; no kernel launch; one profiled frame of det_dimp50_max
    and prdimp50; det_dimp50_max's frame on the card against the CPU."""
    from mmtrack_torch.eval.datasets import load_sequence
    from mmtrack_torch.eval.ope import result_path, run_sequence, save_result

    H, W = OPE_HW
    for name in DIMP_ZOO:
        recipe = TRACKER_REGISTRY[name]
        seq = load_sequence(seq_dir, "DepthTrack")
        if recipe.composition == "rgbrgb":      # mfdimp, an RGB-T tracker
            frames = thermal_frames(seq)
        else:
            seq.dtype = recipe.composition
            frames = None
        t0 = time.perf_counter()
        tracker = FrameRecorder(recipe.build(device=dev))
        build_s = time.perf_counter() - t0
        reset_launches(*KERNEL_COUNTERS)
        t0 = time.perf_counter()
        res = run_sequence(tracker, seq, frame_loader=frames.__getitem__ if frames else None)
        run_s = time.perf_counter() - t0
        launches = launch_counts(KERNEL_COUNTERS)
        want = dict.fromkeys(launches, 0)
        inner = tracker.tracker
        flags, iters = dict(inner.flags), inner.optimizer_iters
        # more frames (the last again), after the count
        last = frames[-1] if frames else get_x_frame(seq.rgb_frames[-1], seq.x_frames[-1],
                                                     seq.dtype, seq.depth_clip)
        syncs = host_syncs(lambda: [inner.track(last) for _ in range(DIMP_SYNC_FRAMES)])
        extra = {}
        if name in DIMP_PROFILED:
            rows, wall_s = profile_window(lambda: inner.track(last), 1)
            dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
            extra = dict(profiled_frame_device_ms=dev_ms, profiled_frame_wall_ms=wall_s * 1e3,
                         device_idle_share=1.0 - dev_ms / (wall_s * 1e3),
                         profiled_frame_kernels=sum(e.count for e in rows),
                         top_kernels=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                                      for e in rows[:6]])
            extra["parts"] = dimp_parts(inner, last)
        ok = zoo_boxes_ok(name, res["boxes"], H, W)
        log("zoo_dimp", tracker=name, family=recipe.family, modality=recipe.modality,
            composition=recipe.composition, dtype="f32", frames=ZOO_FRAMES, frame=f"{W}x{H}",
            sample_size=inner.rt.image_sample_size, boxes_ok=ok, launches=launches,
            expected=want, median_ms_per_frame=float(np.median(tracker.ms[ZOO_WARMUP:])),
            first_frame_ms=tracker.ms[0], build_s=build_s, sequence_s=run_s,
            host_syncs_per_frame=syncs / DIMP_SYNC_FRAMES, flags=flags, optimizer_iters=iters,
            optimizer_iters_computed=(ZOO_FRAMES - 1) * inner.rt.max_update_iter, **extra,
            card=card_line())
        if not ok or launches != want or sum(flags.values()) != ZOO_FRAMES - 1:
            raise AssertionError(f"zoo {name}: boxes ok {ok}, launches {launches}, "
                                 f"flags {flags}")
        if name == "det_dimp50_max":
            dimp_card_vs_cpu(dev, inner, seq)
        if name in ZOO_ENTRIES:
            save_result(result_path(res_in, "DepthTrack", name, seq.name), res,
                        fmt=seq.save_fmt, delimiter=seq.save_delimiter,
                        time_style=seq.time_style)
        del tracker, inner
        torch.cuda.empty_cache()


def dimp_parts(tracker, frame) -> dict:
    """Kernels, device ms and wall ms of the parts of one DiMP frame, each
    profiled alone from the tracker's state: the sample crop with the
    backbones and classification features, the IoU refinement (its
    autograd ascent), and the masked filter update."""
    from mmtrack_torch.trackers.dimp_tracker import _normalize, _refine_box, _sample_geometry

    rt, model, state = tracker.rt, tracker.model, tracker.state
    image = torch.from_numpy(frame).to(state["pos"].device)
    szl, tl, sample_pos, sample_scale = _sample_geometry(
        rt, state["pos"], state["target_scale"], im_hw=image.shape[:2])
    jitter = torch.rand((rt.num_init_random_boxes, 4), generator=torch.Generator().manual_seed(0))
    jitter = jitter.to(image.device)
    no_iter = torch.zeros((), dtype=torch.int64, device=image.device)

    @torch.no_grad()
    def features():
        patch = crop_at(image, state["pos"], szl, rt.image_sample_size, origin_yx=tl)
        bfeat = model.extract_backbone(_normalize(patch)[None])
        return bfeat, model.extract_classification_feat(bfeat)

    bfeat, _ = features()
    parts = {"crop_backbone_features": features,
             "iou_refinement": torch.no_grad()(lambda: _refine_box(
                 rt, model, bfeat, state, sample_pos, sample_scale, jitter)),
             "filter_update_masked": torch.no_grad()(lambda: model.optimize_filter(
                 state["filter"], state["memory_feat"], state["memory_boxes"],
                 state["sample_weights"], no_iter, rt.max_update_iter))}
    out = {}
    for name, fn in parts.items():
        rows, wall_s = profile_window(fn, 1)
        out[name] = dict(kernels=sum(e.count for e in rows), wall_ms=wall_s * 1e3,
                         device_ms=sum(e.self_device_time_total for e in rows) / 1e3)
    return out


def dimp_card_vs_cpu(dev, tracker, seq) -> None:
    """det_dimp50_max on the card (TF32 off) against the same weights and
    draws on the CPU, where tests/test_torch_dimp_tracker.py holds the
    runtime against JAX: both initialise on the sequence's first frame
    (the init filters' difference printed), then the CPU tracker takes the
    card's state and both track the second frame. The not-found threshold
    is 0 here: the seeded weights score below 0.25, and a not-found frame
    would keep the box it had; so the frame refines its box and updates
    the memory. Box within DIMP_BOX_BAR px, score within DIMP_SCORE_BAR,
    the same flag."""
    import dataclasses

    from mmtrack_torch.models.dimp import build_det_dimp50
    from mmtrack_torch.trackers.dimp_tracker import DiMPTracker

    frames = [get_x_frame(seq.rgb_frames[t], seq.x_frames[t], seq.dtype, seq.depth_clip)
              for t in (0, 1)]
    info = {"init_bbox": seq.gt[0].tolist()}
    rt = dataclasses.replace(tracker.rt, target_not_found_threshold=0.0)
    card = DiMPTracker(tracker.model, dev, rt)
    cpu_model = build_det_dimp50("max")
    cpu_model.load_state_dict({k: v.cpu() for k, v in tracker.model.state_dict().items()})
    cpu = DiMPTracker(cpu_model, "cpu", rt)
    card.initialize(frames[0], info)
    t0 = time.perf_counter()
    cpu.initialize(frames[0], info)
    cpu_init_s = time.perf_counter() - t0
    init_filter_diff = float((card.state["filter"].cpu() - cpu.state["filter"]).abs().max())
    cpu.state = {k: v.cpu() if torch.is_tensor(v) else v for k, v in card.state.items()}
    got, want = card.track(frames[1]), cpu.track(frames[1])
    diff = dict(box_max_abs_diff_px=float(np.abs(np.subtract(got["target_bbox"],
                                                             want["target_bbox"])).max()),
                score_abs_diff=abs(got["best_score"] - want["best_score"]),
                flags=(got["flag"], want["flag"]))
    log("zoo_dimp_card_vs_cpu", tracker="det_dimp50_max", **diff, box_bar=DIMP_BOX_BAR,
        score_bar=DIMP_SCORE_BAR, init_filter_max_abs_diff=init_filter_diff,
        cpu_init_s=cpu_init_s,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    if not (diff["box_max_abs_diff_px"] <= DIMP_BOX_BAR
            and diff["score_abs_diff"] <= DIMP_SCORE_BAR and got["flag"] == want["flag"]):
        raise AssertionError(f"det_dimp50_max card vs CPU beyond bars: {diff}")


MF_BOX_BAR = 1e-4                   # MixFormer card vs CPU: boxes, in crop units
MF_LOGIT_BAR = 1e-3                 # and score logits


def mixformer_card_vs_cpu(dev, model) -> None:
    """One full-width MixFormer forward (K = 3 online templates, seeded
    N(0, 1) crops) on the card, TF32 off, against the same weights on the
    CPU, where tests/test_torch_mixformer.py holds the model against JAX:
    boxes within MF_BOX_BAR, logits within MF_LOGIT_BAR (the two sum in
    f32 in other orders through 16 blocks)."""
    from mmtrack_torch.models.mixformer import build_mixformer_rgbd

    cpu = build_mixformer_rgbd(in_channels=model.in_channels)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    C, rng = model.in_channels, np.random.RandomState(0)
    z, ot, x = (torch.from_numpy(rng.randn(*shape, C).astype(np.float32)) for shape in
                ((1, 128, 128), (1, 3, 128, 128), (1, 320, 320)))
    with torch.inference_mode():
        got = model(z.to(dev), ot.to(dev), x.to(dev))
        t0 = time.perf_counter()
        want = cpu.eval()(z, ot, x)
        cpu_s = time.perf_counter() - t0
    diff = {k: float((got[k].cpu() - want[k]).abs().max()) for k in ("pred_boxes", "score_logits")}
    log("zoo_mixformer_card_vs_cpu", in_channels=C, online_templates=3, max_abs_diff=diff,
        box_bar=MF_BOX_BAR, logit_bar=MF_LOGIT_BAR, cpu_forward_s=cpu_s,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    if not (diff["pred_boxes"] <= MF_BOX_BAR and diff["score_logits"] <= MF_LOGIT_BAR):
        raise AssertionError(f"MixFormer card vs CPU beyond bars: {diff}")


def compose_check(dev, seq) -> None:
    """ops/compose.py::compose_rgbcolormap_device on the card over the
    sequence's decoded RGB and raw 16-bit depth, all frames in one call,
    against the host's get_x_frame(..., 'rgbcolormap'): bit equality."""
    from mmtrack_torch.ops.compose import compose_rgbcolormap_device, jet_lut

    n = len(seq.rgb_frames)
    rgb = np.stack([cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in seq.rgb_frames])
    depth = np.stack([cv2.imread(p, -1) for p in seq.x_frames])
    host = np.stack([get_x_frame(seq.rgb_frames[t], seq.x_frames[t], "rgbcolormap",
                                 seq.depth_clip) for t in range(n)])
    rgb_d, depth_d = torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev)
    lut = torch.from_numpy(jet_lut()).to(dev)

    def compose():
        return compose_rgbcolormap_device(rgb_d, depth_d, lut, depth_clip=seq.depth_clip)

    got = compose().cpu().numpy()
    differ = int((got != host).any(-1).sum())
    log("zoo_compose", function="compose_rgbcolormap_device", frames=n,
        frame=f"{rgb.shape[2]}x{rgb.shape[1]}", depth_dtype=str(depth.dtype),
        depth_clip=seq.depth_clip, pixels_differ=differ, ms_for_all_frames=cuda_ms(compose),
        card=card_line())
    if differ:
        raise AssertionError(f"device rgbcolormap compose: {differ} pixels differ from the host's")


DISK_SEQS = 2                       # DepthTrack and LasHeR sequences of DISK_FRAMES, 640x480
DISK_FRAMES = 21                    # the sampler takes sequences of 20 frames or more
RGB_SEQS, RGB_HW = 2, (720, 1280)   # LaSOT and GOT-10k sequences each, 1280x720
LOADER_BATCHES = 1                  # B=32 batches timed per corpus
DISK_STEPS = 1                      # counted vipt steps from disk (and on a resident batch)
DISK_PROFILED = 1                   # vipt steps from disk under torch.profiler
OSTRACK_STEPS = 1                   # counted ostrack steps from disk
ENTRY_SAMPLES = TRAIN_B             # one step per entry run
DISK_PER_STEP = {"flash_mhsa_qkv": 8, "attn_block_fused": 1, "mlp_block_fused": 1}
RGB_MIX = {"DATA": {"TRAIN": {"DATASETS_NAME": ["LASOT", "GOT10K_vottrain"],
                              "DATASETS_RATIO": [1, 1]}}}


def train_fixture(root: str) -> dict:
    """The training corpora in their own layouts under root, written by 8
    threads: DepthTrack (phase 9's fixture), LasHeR (visible/ + infrared/
    JPEGs of the synthetic RGB and aux triplets), LaSOT (class/sequence
    nesting, occlusion files) and GOT-10k (list.txt, absence and cover
    labels) at 1280x720, and an LMDB twin of GOT-10k's images
    (data/minilmdb.py's writer). Returns the roots by dataset name and
    "lmdb"."""
    from concurrent.futures import ThreadPoolExecutor

    from mmtrack_torch.data.minilmdb import write_fixture

    roots = {n: os.path.join(root, n) for n in ("DepthTrack_train", "LasHeR_all", "LASOT",
                                                "GOT10K_vottrain")}
    ope_fixture(roots["DepthTrack_train"], n_seqs=DISK_SEQS, n_frames=DISK_FRAMES)
    jobs, texts = [], {}
    for corpus, n_seqs, (H, W) in (("LasHeR_all", DISK_SEQS, OPE_HW),
                                   ("LASOT", RGB_SEQS, RGB_HW),
                                   ("GOT10K_vottrain", RGB_SEQS, RGB_HW)):
        for i in range(n_seqs):
            rng = np.random.RandomState(300 + i)
            box0 = (rng.uniform(0.1, 0.6) * W, rng.uniform(0.1, 0.6) * H,
                    rng.uniform(0.08, 0.15) * W, rng.uniform(0.1, 0.2) * H)
            frames, gt = make_synthetic_sequence(
                n_frames=DISK_FRAMES, height=H, width=W, seed=300 + i, box0=box0,
                velocity=tuple(rng.uniform(-8, 8, 2)), channels=6 if corpus == "LasHeR_all" else 3)
            gt_txt = "\n".join(",".join(f"{v:.4f}" for v in b) for b in gt) + "\n"
            flags = ",".join(["0"] * DISK_FRAMES) + "\n"
            if corpus == "LasHeR_all":
                seq = os.path.join(roots[corpus], f"seq{i:02d}")
                images = {os.path.join(seq, sub, f"{t:05d}.jpg"): frames[t, :, :, c:c + 3]
                          for t in range(DISK_FRAMES)
                          for sub, c in (("visible", 0), ("infrared", 3))}
                texts[os.path.join(seq, "visible.txt")] = gt_txt
            elif corpus == "LASOT":
                cls = ("cat", "dog")[i % 2]
                seq = os.path.join(roots[corpus], cls, f"{cls}-{i + 1}")
                images = {os.path.join(seq, "img", f"{t + 1:08d}.jpg"): frames[t]
                          for t in range(DISK_FRAMES)}
                texts.update({os.path.join(seq, "groundtruth.txt"): gt_txt,
                              os.path.join(seq, "full_occlusion.txt"): flags,
                              os.path.join(seq, "out_of_view.txt"): flags})
            else:
                seq = os.path.join(roots[corpus], f"GOT-10k_Train_{i + 1:06d}")
                images = {os.path.join(seq, f"{t + 1:08d}.jpg"): frames[t]
                          for t in range(DISK_FRAMES)}
                texts.update({os.path.join(seq, "groundtruth.txt"): gt_txt,
                              os.path.join(seq, "absence.label"): "0\n" * DISK_FRAMES,
                              os.path.join(seq, "cover.label"): "8\n" * DISK_FRAMES})
            for path, img in images.items():
                os.makedirs(os.path.dirname(path), exist_ok=True)
                jobs.append((path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR)))
    texts[os.path.join(roots["GOT10K_vottrain"], "list.txt")] = "".join(
        f"GOT-10k_Train_{i + 1:06d}\n" for i in range(RGB_SEQS))
    for path, text in texts.items():
        with open(path, "w") as f:
            f.write(text)
    with ThreadPoolExecutor(8) as pool:
        if not all(pool.map(lambda job: cv2.imwrite(*job), jobs)):
            raise IOError("could not write the training fixture")
    got = roots["GOT10K_vottrain"]
    items = {}
    for d, _, files in os.walk(got):
        for f in files:
            if f.endswith(".jpg"):
                with open(os.path.join(d, f), "rb") as fh:
                    items[os.path.relpath(os.path.join(d, f), got)] = fh.read()
    roots["lmdb"] = os.path.join(root, "GOT10K_lmdb")
    write_fixture(roots["lmdb"], items)
    return roots


def disk_loader(datasets, ratios, cfg, n_batches: int, seed: int = 0) -> BatchLoader:
    sampler = TrackingSampler(datasets, ratios, samples_per_epoch=n_batches * TRAIN_B,
                              max_gap=cfg.DATA.MAX_SAMPLE_INTERVAL,
                              processing=processing_from_config(cfg), seed=seed)
    return BatchLoader(sampler, TRAIN_B)


def disk_counts() -> dict:
    return launch_counts((flash_mhsa_qkv, attn_block_fused, mlp_block_fused))


def disk_steps(state, step, batches, n: int) -> tuple[float, float, list]:
    """n train steps, each on the loader's next batch: (seconds, seconds
    waiting on the loader, losses), synchronised at the end."""
    wait, losses = 0.0, []
    t0 = time.perf_counter()
    for _ in range(n):
        w0 = time.perf_counter()
        batch = next(batches)
        wait += time.perf_counter() - w0
        losses.append(state_step(state, step, batch))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, wait, losses


def train_entries(tmp: str, roots: dict) -> None:
    """`python -m mmtrack_torch.train.run` as a user runs it, each in its
    own process, with the roots in a local.yaml under a temporary HOME:
    --script ostrack on the RGB mix (a JSON override), then --script vipt
    --config deep_rgbd with --init from the ostrack checkpoint; bf16, one
    B=32 step each. Both must exit 0 and write their checkpoint, and the
    --init must load every name but the prompts' (missing = the prompt
    leaves, unexpected = 0)."""
    import yaml

    home = os.path.join(tmp, "home")
    os.makedirs(os.path.join(home, ".mmtrack_tpu"))
    with open(os.path.join(home, ".mmtrack_tpu", "local.yaml"), "w") as f:
        yaml.safe_dump({"datasets": {"depthtrack_dir": roots["DepthTrack_train"],
                                     "lasot_dir": roots["LASOT"],
                                     "got10k_dir": roots["GOT10K_vottrain"]}}, f)
    mix = os.path.join(tmp, "rgb_mix.json")
    with open(mix, "w") as f:
        json.dump(RGB_MIX, f)
    ws = os.path.join(tmp, "workspace")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, HOME=home,
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    prior = os.path.join(ws, "ostrack-rgb_mix", "checkpoints", "epoch_0001.pt")
    n_prompt = sum(k.startswith(("backbone.prompt_blocks.", "backbone.prompt_norms."))
                   for k in build_viptrack(vipt_experiment_config("deep_rgbd"),
                                           device="meta").state_dict())
    for script, config, extra, ckpt in (
            ("ostrack", mix, [], prior),
            ("vipt", "deep_rgbd", ["--init", prior],
             os.path.join(ws, "vipt-deep_rgbd", "checkpoints", "epoch_0001.pt"))):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mmtrack_torch.train.run", "--script", script,
                               "--config", config, "--bf16", "--epochs", "1", "--samples",
                               str(ENTRY_SAMPLES), "--save_dir", ws] + extra,
                              cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        log("train_disk_entry", script=script, config=os.path.basename(config), seconds=seconds,
            returncode=proc.returncode, checkpoint=os.path.exists(ckpt), stdout=lines[-8:])
        if proc.returncode != 0 or not os.path.exists(ckpt):
            raise AssertionError(f"train entry --script {script} exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        if extra and f"--init {prior}: loaded; missing={n_prompt} unexpected=0" not in lines:
            raise AssertionError(f"train entry --init: {lines}")


def train_disk_path(cfg, dev) -> dict:
    """Phase 11: training from disk. Returns the launches of each kernel
    counted in it."""
    from mmtrack_torch.data import native_io
    from mmtrack_torch.data.datasets import names2datasets
    from mmtrack_torch.data.image_loader import opencv_loader
    from mmtrack_torch.data.lmdb_backend import LmdbBackend, wrap_dataset_with_lmdb
    from mmtrack_torch.data.rgb_datasets import GOT10k

    counted = dict.fromkeys(DISK_PER_STEP, 0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        roots = train_fixture(os.path.join(tmp, "data"))
        write_s = time.perf_counter() - t0
        reader = LmdbBackend(roots["lmdb"]).reader
        log("train_disk_env", decoder=native_io.decoder(), decoder_error=native_io.load_error(),
            lmdb_reader=reader, cpu_count=os.cpu_count(), fixture_write_s=write_s,
            corpora={"DepthTrack_train": f"{DISK_SEQS} x {DISK_FRAMES} x {OPE_HW[1]}x{OPE_HW[0]}",
                     "LasHeR_all": f"{DISK_SEQS} x {DISK_FRAMES} x {OPE_HW[1]}x{OPE_HW[0]}",
                     "LASOT": f"{RGB_SEQS} x {DISK_FRAMES} x {RGB_HW[1]}x{RGB_HW[0]}",
                     "GOT10K_vottrain": f"{RGB_SEQS} x {DISK_FRAMES} x {RGB_HW[1]}x{RGB_HW[0]}"})

        # the LMDB twin reads the directory twin's frames (cv2, as the
        # backend decodes)
        got = roots["GOT10K_vottrain"]
        twin, plain = wrap_dataset_with_lmdb(GOT10k, roots["lmdb"], got), GOT10k(
            got, image_loader=opencv_loader)
        ids = [0, DISK_FRAMES // 2, DISK_FRAMES - 1]
        if not all(np.array_equal(a, b) for a, b in zip(twin.get_frames(0, ids)[0],
                                                        plain.get_frames(0, ids)[0])):
            raise AssertionError("train_disk: LMDB twin frames differ from the directory's")

        rows = {label: (names2datasets(names, {n: roots[n] for n in names}), ratios)
                for label, (names, ratios) in (
                    ("DepthTrack_train (rgbcolormap)", (["DepthTrack_train"], [1])),
                    ("LasHeR_all (rgbrgb)", (["LasHeR_all"], [1])),
                    ("LASOT + GOT10K_vottrain (rgb, 1:1)", (["LASOT", "GOT10K_vottrain"], [1, 1])))}
        rows[f"GOT10K_vottrain LMDB twin ({reader})"] = ([twin], [1])
        loader_s = {}
        for label, (sets, ratios) in rows.items():
            t0 = time.perf_counter()
            shapes = [list(b["search"].shape) for b in disk_loader(sets, ratios, cfg,
                                                                    LOADER_BATCHES)]
            loader_s[label] = (time.perf_counter() - t0) / LOADER_BATCHES
            log("train_disk_loader", corpus=label, B=TRAIN_B, batches=LOADER_BATCHES,
                seconds_per_batch=loader_s[label], search_shapes=shapes)

        # vipt (prompt-only) on DepthTrack from disk, drop path + CE keep 0.7
        stride = cfg.MODEL.BACKBONE.STRIDE
        ce_lens = ce_keep_schedule((cfg.DATA.SEARCH.SIZE // stride) ** 2,
                                   cfg.MODEL.BACKBONE.CE_LOC, cfg.MODEL.BACKBONE.CE_KEEP_RATIO)
        mask = generate_ctr_mask(cfg.DATA.TEMPLATE.SIZE // stride,
                                 cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE, dev)
        step = make_train_step(box_mask_z=mask, ce_keep_lens=ce_lens,
                               weights=(cfg.TRAIN.GIOU_WEIGHT, cfg.TRAIN.L1_WEIGHT,
                                        cfg.TRAIN.FOCAL_WEIGHT),
                               search_size=cfg.DATA.SEARCH.SIZE, stride=stride, seed=0)

        def trainer(build, mask_fn):
            model = build(cfg, dtype=torch.bfloat16, param_dtype=torch.float32, device=dev,
                          seed=0)
            opt, sched = build_optimizer(model, lr=cfg.TRAIN.LR,
                                         weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                                         grad_clip_norm=cfg.TRAIN.GRAD_CLIP_NORM,
                                         trainable_mask=mask_fn(model))
            return TrainState(model, opt, sched), {k: v.clone()
                                                   for k, v in model.state_dict().items()}

        sets, _ = rows["DepthTrack_train (rgbcolormap)"]
        first = next(iter(disk_loader(sets, [1], cfg, 1)))
        first_dev = {k: torch.as_tensor(first[k], device=dev)
                     for k in ("template", "search", "search_anno")}
        train_kernels_vs_plain(cfg, dev, batch=first_dev, label="train_disk_kernels_vs_plain")
        state, start = trainer(build_viptrack, prompt_only_mask)
        state_step(state, step, first_dev)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches(flash_mhsa_qkv, attn_block_fused, mlp_block_fused)
        # a loader started with the timed steps, as at an epoch's start: its
        # one thread is slower than the step, so no batch waits in its queue
        batches = iter(disk_loader(sets, [1], cfg, DISK_STEPS + DISK_PROFILED, seed=1))
        disk_s, wait_s, losses = disk_steps(state, step, batches, DISK_STEPS)
        launches = disk_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        counts, device_ms, wall_ms = profile_pass(
            lambda: disk_steps(state, step, batches, DISK_PROFILED), dev,
            kernels={"attention": (ATTENTION_KERNELS, 9)})
        reset_launches(flash_mhsa_qkv, attn_block_fused, mlp_block_fused)
        t0 = time.perf_counter()
        for _ in range(DISK_STEPS):
            losses.append(state_step(state, step, first_dev))
        torch.cuda.synchronize()
        resident_s = time.perf_counter() - t0
        resident = disk_counts()
        expected = {k: n * DISK_STEPS for k, n in DISK_PER_STEP.items()}
        after = state.model.state_dict()
        moved = [k for k in after if "prompt" in k and not torch.equal(after[k], start[k])]
        n_prompt = sum("prompt" in k for k in after)
        frozen_changed = [k for k in after
                          if "prompt" not in k and not torch.equal(after[k], start[k])]
        losses = [float(v) for v in losses]
        log("train_disk", script="vipt", config="deep_rgbd", corpus="DepthTrack_train",
            dtype="bf16 compute, f32 params", B=TRAIN_B, steps=DISK_STEPS,
            ms_per_step=disk_s / DISK_STEPS * 1e3, samples_per_s=TRAIN_B * DISK_STEPS / disk_s,
            loader_wait_ms_per_step=wait_s / DISK_STEPS * 1e3,
            resident_ms_per_step=resident_s / DISK_STEPS * 1e3,
            resident_samples_per_s=TRAIN_B * DISK_STEPS / resident_s,
            profiled_steps=DISK_PROFILED, profiled_wall_ms=wall_ms, profiled_device_ms=device_ms,
            idle_share=1 - device_ms / wall_ms, profiled_attention_kernels=counts["attention"],
            max_memory_allocated_gib=peak, launches=launches, resident_launches=resident,
            expected=expected, loss_first=losses[0], loss_last=losses[-1],
            all_finite=bool(np.isfinite(losses).all()),
            prompt_leaves_moved=f"{len(moved)}/{n_prompt}", frozen_leaves_changed=frozen_changed,
            loader_seconds_per_batch=loader_s, card=card_line())
        if launches != expected or resident != expected:
            raise AssertionError(f"train_disk vipt: launches {launches} / {resident}, "
                                 f"want {expected}")
        if not np.isfinite(losses).all() or len(moved) != n_prompt or frozen_changed:
            raise AssertionError("train_disk vipt: non-finite loss, unmoved prompt leaf or "
                                 "changed frozen leaf")
        for k, n in launches.items():
            counted[k] += 2 * n
        del state, start, after
        torch.cuda.empty_cache()

        # ostrack (every parameter) on the RGB mix from disk: 3-channel
        # crops never reach the auxiliary patch embedding, which only
        # weight decay moves
        sets, ratios = rows["LASOT + GOT10K_vottrain (rgb, 1:1)"]
        state, start = trainer(build_ostrack, lambda model: None)
        warm = next(iter(disk_loader(sets, ratios, cfg, 1)))
        if warm["search"].shape[-1] != 3:
            raise AssertionError(f"train_disk ostrack: batch {warm['search'].shape}")
        state_step(state, step, warm)
        torch.cuda.synchronize()
        reset_launches(flash_mhsa_qkv, attn_block_fused, mlp_block_fused)
        batches = iter(disk_loader(sets, ratios, cfg, OSTRACK_STEPS, seed=1))
        disk_s, wait_s, losses = disk_steps(state, step, batches, OSTRACK_STEPS)
        launches = disk_counts()
        expected = {k: n * OSTRACK_STEPS for k, n in DISK_PER_STEP.items()}
        after = state.model.state_dict()
        decay = 1 - cfg.TRAIN.LR * cfg.TRAIN.WEIGHT_DECAY
        unreached = [k for k in after if "patch_embed_prompt" in k]
        unmoved = [k for k in after if k not in unreached and torch.equal(after[k], start[k])]
        decay_only = all(torch.allclose(after[k], start[k] * decay ** (1 + OSTRACK_STEPS),
                                        rtol=1e-6, atol=0) for k in unreached)
        losses = [float(v) for v in losses]
        log("train_disk", script="ostrack", config="deep_rgbd + RGB mix",
            corpus="LASOT + GOT10K_vottrain", dtype="bf16 compute, f32 params", B=TRAIN_B,
            steps=OSTRACK_STEPS, ms_per_step=disk_s / OSTRACK_STEPS * 1e3,
            samples_per_s=TRAIN_B * OSTRACK_STEPS / disk_s,
            loader_wait_ms_per_step=wait_s / OSTRACK_STEPS * 1e3, launches=launches,
            expected=expected, losses=losses, leaves=len(after),
            leaves_moved=len(after) - len(unmoved) - len(unreached), unmoved=unmoved,
            patch_embed_prompt_by_decay_only=decay_only, card=card_line())
        if launches != expected or unmoved or not decay_only or not np.isfinite(losses).all():
            raise AssertionError("train_disk ostrack: launches, an unmoved leaf, the auxiliary "
                                 "embedding or a non-finite loss")
        for k, n in launches.items():
            counted[k] += n
        del state, start, after
        torch.cuda.empty_cache()

        train_entries(tmp, roots)
    return counted

# phase 12: the ATOM and DCF families; no kernel of the port runs on
# their paths
ATOM_DCF = ("atom", "det_atom_max", "det_atom_mean", "det_atom_mc", "eco", "ccot", "mosse",
            "scsrdcf")
ATOM_DCF_PROFILED = ("det_atom_max", "eco")
ATOM_BOX_BAR = 1e-3                 # det_atom_max card vs CPU: box, px
ECO_BOX_BAR = 1e-2                  # eco card vs CPU: box, px (cuFFT against pocketfft)
SCORE_BAR = 1e-4                    # and score, both
CARD_VS_CPU_FRAME = 10              # the compared frame: frame_num 11 runs the filter CG


def tree_to(x, dev):
    """Tensors of a state or constants tree (dicts, tuples, lists) on dev."""
    if isinstance(x, dict):
        return {k: tree_to(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(tree_to(v, dev) for v in x)
    return x.to(dev) if torch.is_tensor(x) else x


def atom_dcf_path(dev) -> None:
    """Phase 12: the eight ATOM and DCF recipes from the registry at f32 on
    seeded weights over phase 10's 21-frame 640x480 sequence: boxes, the
    median ms per frame after ZOO_WARMUP frames, host syncs per frame, the
    flags (ATOM) and CG iterations run, no kernel launch; one profiled
    frame of det_atom_max and eco; both on the card against the CPU; the
    eco entry in its own process."""
    from mmtrack_torch.eval.datasets import list_sequences, load_sequence
    from mmtrack_torch.eval.ope import result_path, run_sequence, save_result

    H, W = OPE_HW
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "DepthTrack")
        ope_fixture(root, n_seqs=1, n_frames=ZOO_FRAMES)
        seq_dir = list_sequences(root, "DepthTrack")[0]
        res_in = os.path.join(tmp, "in_process")
        for name in ATOM_DCF:
            recipe = TRACKER_REGISTRY[name]
            seq = load_sequence(seq_dir, "DepthTrack")
            seq.dtype = recipe.composition
            t0 = time.perf_counter()
            tracker = FrameRecorder(recipe.build(device=dev))
            build_s = time.perf_counter() - t0
            reset_launches(*KERNEL_COUNTERS)
            t0 = time.perf_counter()
            res = run_sequence(tracker, seq)
            run_s = time.perf_counter() - t0
            launches = launch_counts(KERNEL_COUNTERS)
            want = dict.fromkeys(launches, 0)
            inner = tracker.tracker
            flags = dict(getattr(inner, "flags", {}))
            cg_iters = getattr(inner, "cg_iters", 0)
            last = get_x_frame(seq.rgb_frames[-1], seq.x_frames[-1], seq.dtype, seq.depth_clip)
            sites = host_sync_sites(lambda: [inner.track(last) for _ in range(DIMP_SYNC_FRAMES)])
            extra = {}
            if name in ATOM_DCF_PROFILED:
                rows, wall_s = profile_window(lambda: inner.track(last), 1)
                dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
                extra = dict(profiled_frame_device_ms=dev_ms, profiled_frame_wall_ms=wall_s * 1e3,
                             device_idle_share=1.0 - dev_ms / (wall_s * 1e3),
                             profiled_frame_kernels=sum(e.count for e in rows),
                             top_kernels=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                                          for e in rows[:6]])
            ok = zoo_boxes_ok(name, res["boxes"], H, W)
            log("atom_dcf", tracker=name, family=recipe.family, modality=recipe.modality,
                composition=recipe.composition, dtype="f32", frames=ZOO_FRAMES,
                frame=f"{W}x{H}", sample_size=inner.geom.sample_sz if hasattr(inner, "geom")
                else inner.rt.image_sample_size, boxes_ok=ok, launches=launches, expected=want,
                median_ms_per_frame=float(np.median(tracker.ms[ZOO_WARMUP:])),
                first_frame_ms=tracker.ms[0], build_s=build_s, sequence_s=run_s,
                host_syncs_per_frame=len(sites) / DIMP_SYNC_FRAMES,
                sync_sites=sorted(set(sites)), flags=flags, cg_iters=cg_iters,
                boxes_extent=[float(res["boxes"][:, 0].min()), float(res["boxes"][:, 1].min()),
                              float((res["boxes"][:, 0] + res["boxes"][:, 2]).max()),
                              float((res["boxes"][:, 1] + res["boxes"][:, 3]).max())],
                **extra, card=card_line())
            if not ok or launches != want or (flags and sum(flags.values()) != ZOO_FRAMES - 1):
                raise AssertionError(f"atom_dcf {name}: boxes ok {ok}, launches {launches}, "
                                     f"flags {flags}")
            if name == "det_atom_max":
                atom_card_vs_cpu(dev, inner, seq)
            if name == "eco":
                eco_card_vs_cpu(dev, inner, seq)
            if name in ZOO_ENTRIES:
                save_result(result_path(res_in, "DepthTrack", name, seq.name), res,
                            fmt=seq.save_fmt, delimiter=seq.save_delimiter,
                            time_style=seq.time_style)
            del tracker, inner
            torch.cuda.empty_cache()
        defer_entries([n for n in ZOO_ENTRIES if n in ATOM_DCF], root, seq_dir, res_in)
    log("atom_dcf_phase", seconds=time.perf_counter() - t_phase, recipes=len(ATOM_DCF))


def _card_vs_cpu_frames(seq, n: int) -> list:
    return [get_x_frame(seq.rgb_frames[t], seq.x_frames[t], seq.dtype, seq.depth_clip)
            for t in range(n + 1)]


def atom_card_vs_cpu(dev, tracker, seq) -> None:
    """det_atom_max on the card (TF32 off) against the same weights and
    draws on the CPU, where tests/test_torch_atom.py holds the runtime
    against JAX: the card tracks CARD_VS_CPU_FRAME - 1 frames, the CPU
    takes its state, and both track the next frame, whose filter update
    runs 5 CG iterations. The not-found threshold is 0 (the seeded weights
    score below 0.25), so the frame refines its box and updates the
    memory. Box within ATOM_BOX_BAR px, score within SCORE_BAR, the same
    flag, and the updated filters' difference printed."""
    import dataclasses

    from mmtrack_torch.models.atom import build_det_atom
    from mmtrack_torch.trackers.atom_tracker import ATOMTracker

    frames = _card_vs_cpu_frames(seq, CARD_VS_CPU_FRAME)
    rt = dataclasses.replace(tracker.rt, target_not_found_threshold=0.0)
    card = ATOMTracker(tracker.model, dev, rt)
    cpu_model = build_det_atom("max")
    cpu_model.load_state_dict({k: v.cpu() for k, v in tracker.model.state_dict().items()})
    cpu = ATOMTracker(cpu_model, "cpu", rt)
    card.initialize(frames[0], {"init_bbox": seq.gt[0].tolist()})
    for f in frames[1:-1]:
        card.track(f)
    cpu._draw = card._draw
    cpu.state = tree_to(card.state, torch.device("cpu"))
    draw_state = card._draw.generator.get_state()
    got = card.track(frames[-1])
    cpu._draw.generator.set_state(draw_state)
    t0 = time.perf_counter()
    want = cpu.track(frames[-1])
    cpu_s = time.perf_counter() - t0
    diff = dict(box_max_abs_diff_px=float(np.abs(np.subtract(got["target_bbox"],
                                                             want["target_bbox"])).max()),
                score_abs_diff=abs(got["best_score"] - want["best_score"]),
                flags=(got["flag"], want["flag"]), cg_iters=(got["cg_iters"], want["cg_iters"]),
                filter_max_abs_diff=float((card.state["filter"].cpu()
                                           - cpu.state["filter"]).abs().max()))
    log("atom_dcf_card_vs_cpu", tracker="det_atom_max", frame=CARD_VS_CPU_FRAME, **diff,
        box_bar=ATOM_BOX_BAR, score_bar=SCORE_BAR, cpu_frame_s=cpu_s,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    if not (diff["box_max_abs_diff_px"] <= ATOM_BOX_BAR and diff["score_abs_diff"] <= SCORE_BAR
            and got["flag"] == want["flag"] and got["cg_iters"] == want["cg_iters"] > 0):
        raise AssertionError(f"det_atom_max card vs CPU beyond bars: {diff}")


def eco_card_vs_cpu(dev, tracker, seq) -> None:
    """eco on the card against the same weights on the CPU, where
    tests/test_torch_eco.py holds the runtime against JAX: the card tracks
    CARD_VS_CPU_FRAME - 1 frames, the CPU takes its state and constants,
    and both track the next frame, a training frame (the filter CG with
    the carried direction). Box within ECO_BOX_BAR px (cuFFT against
    pocketfft under CG), score within SCORE_BAR."""
    from mmtrack_torch.models.backbones import resnet18_vggmconv1
    from mmtrack_torch.trackers.eco_tracker import ECOTracker, eco_trains

    frames = _card_vs_cpu_frames(seq, CARD_VS_CPU_FRAME)
    card = ECOTracker(tracker.model, dev, tracker.rt)
    cpu_model = resnet18_vggmconv1()
    cpu_model.load_state_dict({k: v.cpu() for k, v in tracker.model.state_dict().items()})
    cpu = ECOTracker(cpu_model, "cpu", tracker.rt)
    card.initialize(frames[0], {"init_bbox": seq.gt[0].tolist()})
    for f in frames[1:-1]:
        card.track(f)
    cpu_dev = torch.device("cpu")
    cpu.geom, cpu.consts = card.geom, tree_to(card.consts, cpu_dev)
    cpu.state = tree_to(card.state, cpu_dev)
    got = card.track(frames[-1])
    t0 = time.perf_counter()
    want = cpu.track(frames[-1])
    cpu_s = time.perf_counter() - t0
    diff = dict(box_max_abs_diff_px=float(np.abs(np.subtract(got["target_bbox"],
                                                             want["target_bbox"])).max()),
                score_abs_diff=abs(got["best_score"] - want["best_score"]),
                trained=eco_trains(tracker.rt, card.state["frame_num"]),
                filter_max_abs_diff=max(float((a.cpu() - b).abs().max()) for a, b in
                                        zip(card.state["filters"], cpu.state["filters"])))
    log("atom_dcf_card_vs_cpu", tracker="eco", frame=CARD_VS_CPU_FRAME,
        sample_size=card.geom.sample_sz, **diff, box_bar=ECO_BOX_BAR, score_bar=SCORE_BAR,
        cpu_frame_s=cpu_s,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    if not (diff["box_max_abs_diff_px"] <= ECO_BOX_BAR and diff["score_abs_diff"] <= SCORE_BAR
            and diff["trained"]):
        raise AssertionError(f"eco card vs CPU beyond bars: {diff}")

# phase 13: the MDNet family; no kernel of the port runs on its path
MDNET_ZOO = ("mdnet", "pymdnet", "pyvital", "manet", "apfnet", "dafnet", "macnet")
MDNET_PROFILED = ("pymdnet", "apfnet")
MDNET_CARD_VS_CPU = ("pymdnet", "manet")
MDNET_ENTRY = "apfnet"
MDNET_FRAME = 9                     # the 10th frame: frame_num 10, a long-term update
MDNET_BOX_BAR = 1e-3                # card vs CPU: box, px
MDNET_FC_REL_BAR = 1e-4             # and the fc leaves, of their largest magnitude


def lasher_fixture(seq, root: str) -> str:
    """A one-sequence LasHeR layout (visible/*.jpg, infrared/*.jpg,
    visible.txt) of a DepthTrack sequence: its colour JPEGs as they are,
    and phase 10's thermal stand-in of its depth."""
    import shutil

    seq_dir = os.path.join(root, seq.name)
    for sub in ("visible", "infrared"):
        os.makedirs(os.path.join(seq_dir, sub))
    for t, (c, d) in enumerate(zip(seq.rgb_frames, seq.x_frames)):
        shutil.copy(c, os.path.join(seq_dir, "visible", f"{t:06d}.jpg"))
        if not cv2.imwrite(os.path.join(seq_dir, "infrared", f"{t:06d}.jpg"), thermal_standin(d)):
            raise IOError("could not write the LasHeR fixture")
    np.savetxt(os.path.join(seq_dir, "visible.txt"), seq.gt, delimiter=",", fmt="%.4f")
    return seq_dir


def mdnet_path(dev) -> None:
    """Phase 13: the seven MDNet-family recipes from the registry at f32 on
    seeded weights over phase 10's 21-frame 640x480 sequence (mdnet on its
    rgbcolormap frames, the others on rgbrgb frames of its LasHeR twin):
    boxes, the init and median ms per frame, the updates and failures,
    host syncs per frame, peak memory, no kernel launch; one profiled
    long-term update of pymdnet and apfnet; pymdnet and manet on the card
    against the CPU; the apfnet entry in its own process."""
    from mmtrack_torch.eval.datasets import list_sequences, load_sequence
    from mmtrack_torch.eval.ope import result_path, run_sequence, save_result

    H, W = OPE_HW
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "DepthTrack")
        ope_fixture(root, n_seqs=1, n_frames=ZOO_FRAMES)
        depth_dir = list_sequences(root, "DepthTrack")[0]
        lasher_root = os.path.join(tmp, "LasHeR")
        lasher_dir = lasher_fixture(load_sequence(depth_dir, "DepthTrack"), lasher_root)
        res_in = os.path.join(tmp, "in_process")
        for name in MDNET_ZOO:
            recipe = TRACKER_REGISTRY[name]
            seq = (load_sequence(depth_dir, "DepthTrack") if recipe.modality == "rgb"
                   else load_sequence(lasher_dir, "LasHeR"))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tracker = FrameRecorder(recipe.build(device=dev))
            build_s = time.perf_counter() - t0
            inner = tracker.tracker
            reset_launches(*KERNEL_COUNTERS)
            t0 = time.perf_counter()
            res = run_sequence(tracker, seq)
            run_s = time.perf_counter() - t0
            launches = launch_counts(KERNEL_COUNTERS)
            want = dict.fromkeys(launches, 0)
            peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
            updates, failures = dict(inner.updates), inner.failures
            last = get_x_frame(seq.rgb_frames[-1], seq.x_frames[-1], seq.dtype, seq.depth_clip)
            sites = host_sync_sites(lambda: [inner.track(last) for _ in range(DIMP_SYNC_FRAMES)])
            extra = {}
            if name in MDNET_PROFILED:
                while (inner.state["frame_num"] + 1) % inner.rt.long_interval:
                    inner.track(last)
                before = dict(inner.state)

                def update_frame(inner=inner, before=before):
                    # every call from the same state: a long-term update frame
                    inner.state = dict(before)
                    inner.track(last)

                rows, wall_s = profile_window(update_frame, 1)
                dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
                extra = dict(profiled_frame_device_ms=dev_ms, profiled_frame_wall_ms=wall_s * 1e3,
                             device_idle_share=1.0 - dev_ms / (wall_s * 1e3),
                             profiled_frame_kernels=sum(e.count for e in rows),
                             profiled_frame_updated=inner.last_aux["do_update"],
                             top_kernels=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                                          for e in rows[:6]])
            ok = zoo_boxes_ok(name, res["boxes"], H, W)
            log("mdnet", tracker=name, family=recipe.family, modality=recipe.modality,
                composition=seq.dtype, dtype="f32", frames=ZOO_FRAMES, frame=f"{W}x{H}",
                model=type(inner.model).__name__, candidates=inner.rt.n_samples,
                boxes_ok=ok, launches=launches, expected=want, init_ms=tracker.init_ms,
                median_ms_per_frame=float(np.median(tracker.ms[ZOO_WARMUP:])),
                first_frame_ms=tracker.ms[0], build_s=build_s, sequence_s=run_s,
                updates=updates, failures=failures,
                host_syncs_per_frame=len(sites) / DIMP_SYNC_FRAMES,
                sync_sites=sorted(set(sites)), peak_memory_mb=peak_mb,
                memory_rings_mb=(inner.state["pos_mem"].numel() + inner.state["neg_mem"].numel())
                * 4 / 2 ** 20, **extra, card=card_line())
            if not ok or launches != want or extra and not extra["profiled_frame_updated"]:
                raise AssertionError(f"mdnet {name}: boxes ok {ok}, launches {launches}, "
                                     f"profiled update {extra.get('profiled_frame_updated')}")
            if name in MDNET_CARD_VS_CPU:
                mdnet_card_vs_cpu(dev, name, inner, seq)
            if name == MDNET_ENTRY:
                save_result(result_path(res_in, "LasHeR", name, seq.name), res,
                            fmt=seq.save_fmt, delimiter=seq.save_delimiter,
                            time_style=seq.time_style)
            del tracker, inner
        torch.cuda.empty_cache()
        defer_entries([MDNET_ENTRY], lasher_root, lasher_dir, res_in, dataset="LasHeR")
    log("mdnet_phase", seconds=time.perf_counter() - t_phase, recipes=len(MDNET_ZOO))


def mdnet_card_vs_cpu(dev, name: str, tracker, seq) -> None:
    """An MDNet recipe on the card (TF32 off) against the same weights and
    draws on the CPU, where tests/test_torch_mdnet_tracker.py holds the
    protocol against JAX: the card tracks MDNET_FRAME - 1 frames, the CPU
    takes its state, and both track the next, frame_num 10, a long-term
    update (15 SGD iterations with mining). Box within MDNET_BOX_BAR px,
    score within SCORE_BAR, success, the top 5 and every iteration's mined
    negatives equal, the fc leaves within MDNET_FC_REL_BAR of their largest
    magnitude."""
    import copy

    from mmtrack_torch.trackers.mdnet_tracker import MDNetTracker

    frames = _card_vs_cpu_frames(seq, MDNET_FRAME)
    card = MDNetTracker(tracker.model, dev, tracker.rt)
    cpu = MDNetTracker(copy.deepcopy(tracker.model), "cpu", tracker.rt)
    card.initialize(frames[0], {"init_bbox": seq.gt[0].tolist()})
    for f in frames[1:-1]:
        card.track(f)
    cpu._draw = card._draw
    cpu.state = tree_to(card.state, torch.device("cpu"))
    draw_state = card._draw.generator.get_state()
    got = card.track(frames[-1])
    cpu._draw.generator.set_state(draw_state)
    t0 = time.perf_counter()
    want = cpu.track(frames[-1])
    cpu_s = time.perf_counter() - t0
    a, b = card.last_aux, cpu.last_aux
    mined_equal = (len(a["mined"]) == len(b["mined"]) == card.rt.update_iters
                   and all(torch.equal(x.cpu(), y) for x, y in zip(a["mined"], b["mined"])))
    fc_rel = max(float((card.state["fc"][k].cpu() - v).abs().max() / v.abs().max())
                 for k, v in cpu.state["fc"].items())
    diff = dict(box_max_abs_diff_px=float(np.abs(np.subtract(got["target_bbox"],
                                                             want["target_bbox"])).max()),
                score_abs_diff=abs(got["best_score"] - want["best_score"]),
                success=(a["success"], b["success"]), long_update=(a["long_update"],
                                                                    b["long_update"]),
                top5_equal=torch.equal(a["top_idx"].cpu(), b["top_idx"]),
                mined_equal=mined_equal, fc_max_rel_diff=fc_rel)
    log("mdnet_card_vs_cpu", tracker=name, frame=MDNET_FRAME,
        frame_num=card.state["frame_num"], **diff, box_bar=MDNET_BOX_BAR, score_bar=SCORE_BAR,
        fc_rel_bar=MDNET_FC_REL_BAR, cpu_frame_s=cpu_s,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    if not (diff["box_max_abs_diff_px"] <= MDNET_BOX_BAR and diff["score_abs_diff"] <= SCORE_BAR
            and a["success"] == b["success"] and a["do_update"] and diff["top5_equal"]
            and mined_equal and fc_rel <= MDNET_FC_REL_BAR):
        raise AssertionError(f"{name} card vs CPU beyond bars: {diff}")


# phase 14: KeepTrack and KYS; no kernel of the port runs on their paths
KEEPTRACK_KYS = ("keep_track", "kys")
KK_ENTRY = "kys"
KK_FUSED_BAR = 1e-4                 # KYS card vs CPU: the fused map


def keeptrack_forced_match(tracker, frame) -> dict:
    """One KeepTrack step that takes the match branch: from the tracker's
    state with the filter scaled so the frame's scores peak at 1, mem_ok
    set and the previous collection the frame's own peaks (several valid),
    so the learned matcher's matches decide the frame. Returns the step's
    output."""
    from mmtrack_torch.trackers.dimp_tracker import _normalize, _sample_geometry
    from mmtrack_torch.trackers.keep_track import extract_peaks, init_peak_state, peak_keypoints

    rt, model, state = tracker.rt, tracker.model, dict(tracker.state)
    image = torch.from_numpy(frame).to(state["pos"].device)
    szl, tl, _, _ = _sample_geometry(rt, state["pos"], state["target_scale"],
                                     im_hw=image.shape[:2])
    with torch.no_grad():
        patch = _normalize(crop_at(image, state["pos"], szl, rt.image_sample_size, origin_yx=tl))
        bfeat = model.extract_backbone(patch[None])
        scores = model.classify(state["filter"], model.extract_classification_feat(bfeat))[0]
        state["filter"] = state["filter"] / scores.max()
        scores = scores / scores.max()
        p_scores, p_coords, p_valid = extract_peaks(scores, rt.peaks)
        desc = tracker.matcher.descriptor_extractor(bfeat["layer3"][0], p_coords)
        kpts = peak_keypoints(p_coords, rt.score_sz, tl, szl)
        state["peaks"] = init_peak_state(rt.peaks, p_scores, p_coords, kpts, p_valid, desc,
                                         certain=state["frame_num"] < 10)
    state["mem_ok"] = torch.ones_like(state["mem_ok"])
    tracker.state = state
    out = tracker.track(frame)
    out["prev_valid_peaks"] = int(p_valid.sum())
    return out


def keeptrack_kys_path(dev) -> None:
    """Phase 14: keep_track and kys from the registry at f32 on seeded
    weights over phase 10's 21-frame 640x480 sequence: boxes, the init and
    median ms per frame, flags, KeepTrack's branches and matcher passes,
    KYS's shifted frames, host syncs per frame with their sites, peak
    memory, no kernel launch; the match branch forced once if no frame took
    it; one profiled frame of each; each on the card against the CPU; the
    kys entry in its own process."""
    from mmtrack_torch.eval.datasets import list_sequences, load_sequence
    from mmtrack_torch.eval.ope import result_path, run_sequence, save_result

    H, W = OPE_HW
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "DepthTrack")
        ope_fixture(root, n_seqs=1, n_frames=ZOO_FRAMES)
        seq_dir = list_sequences(root, "DepthTrack")[0]
        res_in = os.path.join(tmp, "in_process")
        for name in KEEPTRACK_KYS:
            recipe = TRACKER_REGISTRY[name]
            seq = load_sequence(seq_dir, "DepthTrack")
            seq.dtype = recipe.composition
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tracker = FrameRecorder(recipe.build(device=dev))
            build_s = time.perf_counter() - t0
            inner = tracker.tracker
            reset_launches(*KERNEL_COUNTERS)
            t0 = time.perf_counter()
            res = run_sequence(tracker, seq)
            run_s = time.perf_counter() - t0
            launches = launch_counts(KERNEL_COUNTERS)
            want = dict.fromkeys(launches, 0)
            peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
            flags = dict(inner.flags)
            extra = ({"branches": dict(inner.branches), "matcher_passes": inner.matcher_passes}
                     if name == "keep_track" else {"shifted_frames": inner.shifts})
            last = get_x_frame(seq.rgb_frames[-1], seq.x_frames[-1], seq.dtype, seq.depth_clip)
            sites = host_sync_sites(lambda: [inner.track(last) for _ in range(DIMP_SYNC_FRAMES)])
            rows, wall_s = profile_window(lambda: inner.track(last), 1)
            dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
            ok = zoo_boxes_ok(name, res["boxes"], H, W)
            log("keeptrack_kys", tracker=name, family=recipe.family, modality=recipe.modality,
                composition=seq.dtype, dtype="f32", frames=ZOO_FRAMES, frame=f"{W}x{H}",
                sample_size=inner.rt.image_sample_size, boxes_ok=ok, launches=launches,
                expected=want, init_ms=tracker.init_ms,
                median_ms_per_frame=float(np.median(tracker.ms[ZOO_WARMUP:])),
                first_frame_ms=tracker.ms[0], build_s=build_s, sequence_s=run_s, flags=flags,
                optimizer_iters=inner.optimizer_iters, **extra,
                host_syncs_per_frame=len(sites) / DIMP_SYNC_FRAMES,
                sync_sites=sorted(set(sites)), peak_memory_mb=peak_mb,
                boxes_extent=[float(res["boxes"][:, 0].min()), float(res["boxes"][:, 1].min()),
                              float((res["boxes"][:, 0] + res["boxes"][:, 2]).max()),
                              float((res["boxes"][:, 1] + res["boxes"][:, 3]).max())],
                profiled_frame_device_ms=dev_ms, profiled_frame_wall_ms=wall_s * 1e3,
                device_idle_share=1.0 - dev_ms / (wall_s * 1e3),
                profiled_frame_kernels=sum(e.count for e in rows),
                top_kernels=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                             for e in rows[:6]], card=card_line())
            if not ok or launches != want or sum(flags.values()) != ZOO_FRAMES - 1:
                raise AssertionError(f"keeptrack_kys {name}: boxes ok {ok}, launches {launches}, "
                                     f"flags {flags}")
            if name == "keep_track" and inner.matcher_passes == 0:
                out = keeptrack_forced_match(inner, last)
                log("keeptrack_forced_match", tracker=name, branch=out["branch"],
                    prev_valid_peaks=out["prev_valid_peaks"], flag=out["flag"],
                    selected_id=out["selected_id"], matcher_passes=inner.matcher_passes,
                    note="seeded weights left the match branch unused; one step forced it")
                if out["branch"] != "match":
                    raise AssertionError(f"keep_track: the forced step took {out['branch']}")
            keeptrack_kys_card_vs_cpu(dev, name, inner, seq)
            if name == KK_ENTRY:
                save_result(result_path(res_in, "DepthTrack", name, seq.name), res,
                            fmt=seq.save_fmt, delimiter=seq.save_delimiter,
                            time_style=seq.time_style)
            del tracker, inner
            torch.cuda.empty_cache()
        defer_entries([KK_ENTRY], root, seq_dir, res_in)
    log("keeptrack_kys_phase", seconds=time.perf_counter() - t_phase,
        recipes=len(KEEPTRACK_KYS))


def keeptrack_kys_card_vs_cpu(dev, name: str, tracker, seq) -> None:
    """keep_track or kys on the card (TF32 off) against the same weights
    and draws on the CPU, where tests/test_torch_{keeptrack,kys}.py hold
    the runtimes against JAX: the card tracks CARD_VS_CPU_FRAME - 1 frames,
    the CPU takes its state, and both track the next. Box within
    MDNET_BOX_BAR px, score within SCORE_BAR, the same flag; KeepTrack's
    branch and selected id equal, KYS's fused map within KK_FUSED_BAR."""
    import copy

    from mmtrack_torch.trackers.keeptrack_tracker import KeepTrackTracker
    from mmtrack_torch.trackers.kys_tracker import KYSTracker

    frames = _card_vs_cpu_frames(seq, CARD_VS_CPU_FRAME)
    if name == "keep_track":
        card = KeepTrackTracker(tracker.model, dev, tracker.rt, matcher=tracker.matcher)
        cpu = KeepTrackTracker(copy.deepcopy(tracker.model), "cpu", tracker.rt,
                               matcher=copy.deepcopy(tracker.matcher))
    else:
        card = KYSTracker(tracker.model, dev, tracker.rt)
        cpu = KYSTracker(copy.deepcopy(tracker.model), "cpu", tracker.rt)
    card.initialize(frames[0], {"init_bbox": seq.gt[0].tolist()})
    for f in frames[1:-1]:
        card.track(f)
    cpu._draw = card._draw
    cpu.state = tree_to(card.state, torch.device("cpu"))
    draw_state = card._draw.generator.get_state()
    got = card.track(frames[-1])
    cpu._draw.generator.set_state(draw_state)
    t0 = time.perf_counter()
    want = cpu.track(frames[-1])
    cpu_s = time.perf_counter() - t0
    diff = dict(box_max_abs_diff_px=float(np.abs(np.subtract(got["target_bbox"],
                                                             want["target_bbox"])).max()),
                score_abs_diff=abs(got["best_score"] - want["best_score"]),
                flags=(got["flag"], want["flag"]))
    same = got["flag"] == want["flag"]
    if name == "keep_track":
        diff.update(branches=(got["branch"], want["branch"]),
                    selected_ids=(got["selected_id"], want["selected_id"]))
        same &= got["branch"] == want["branch"] and got["selected_id"] == want["selected_id"]
    else:
        diff["fused_max_abs_diff"] = float((card.state["last_fused"].cpu()
                                            - cpu.state["last_fused"]).abs().max())
        same &= diff["fused_max_abs_diff"] <= KK_FUSED_BAR
    log("keeptrack_kys_card_vs_cpu", tracker=name, frame=CARD_VS_CPU_FRAME, **diff,
        box_bar=MDNET_BOX_BAR, score_bar=SCORE_BAR, cpu_frame_s=cpu_s,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    if not (same and diff["box_max_abs_diff_px"] <= MDNET_BOX_BAR
            and diff["score_abs_diff"] <= SCORE_BAR):
        raise AssertionError(f"{name} card vs CPU beyond bars: {diff}")


# phase 15: LWL and STM; no kernel of the port runs on their paths
LWL_STM = ("lwl", "stm")
LS_ENTRY = "stm"
LS_MASK_BAR = 1e-3                  # card vs CPU: the share of mask pixels that differ
LS_FILTER_REL_BAR = 1e-4            # and LWL's filter, of its largest magnitude
LS_VOT_FRAMES = 8


class MaskRecorder(FrameRecorder):
    """A FrameRecorder that also checks each frame's mask: an (H, W) bool
    map, counting the non-empty ones."""

    def __init__(self, tracker, hw):
        super().__init__(tracker)
        self.hw, self.masks_ok, self.nonempty = hw, True, 0

    def track(self, image, info=None):
        out = super().track(image, info)
        m = out["segmentation"]
        self.masks_ok &= isinstance(m, np.ndarray) and m.dtype == bool and m.shape == self.hw
        self.nonempty += int(m.any())
        return out


def lwl_stm_path(dev) -> None:
    """Phase 15: lwl and stm from the registry at f32 on seeded weights over
    phase 10's 21-frame 640x480 sequence: boxes and masks, the init and
    median ms per frame, LWL's updates and GN steps, STM's commits, host
    syncs per frame with their sites, peak memory, no kernel launch; one
    profiled frame of each; each on the card against the CPU; the stm
    entry and the lwl mask-protocol VOT entry, each in its own process."""
    from mmtrack_torch.eval.datasets import list_sequences, load_sequence
    from mmtrack_torch.eval.ope import result_path, run_sequence, save_result

    H, W = OPE_HW
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "DepthTrack")
        ope_fixture(root, n_seqs=1, n_frames=ZOO_FRAMES)
        seq_dir = list_sequences(root, "DepthTrack")[0]
        res_in = os.path.join(tmp, "in_process")
        for name in LWL_STM:
            recipe = TRACKER_REGISTRY[name]
            seq = load_sequence(seq_dir, "DepthTrack")
            seq.dtype = recipe.composition
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tracker = MaskRecorder(recipe.build(device=dev), (H, W))
            build_s = time.perf_counter() - t0
            inner = tracker.tracker
            reset_launches(*KERNEL_COUNTERS)
            t0 = time.perf_counter()
            res = run_sequence(tracker, seq)
            run_s = time.perf_counter() - t0
            launches = launch_counts(KERNEL_COUNTERS)
            want = dict.fromkeys(launches, 0)
            peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
            extra = ({"memory_updates": inner.updates, "gn_steps": inner.optimizer_iters}
                     if name == "lwl" else {"commits": inner.commits})
            last = get_x_frame(seq.rgb_frames[-1], seq.x_frames[-1], seq.dtype, seq.depth_clip)
            sites = host_sync_sites(lambda: [inner.track(last) for _ in range(DIMP_SYNC_FRAMES)])
            rows, wall_s = profile_window(lambda: inner.track(last), 1)
            dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
            ok = zoo_boxes_ok(name, res["boxes"], H, W)
            log("lwl_stm", tracker=name, family=recipe.family, modality=recipe.modality,
                composition=seq.dtype, dtype="f32", frames=ZOO_FRAMES, frame=f"{W}x{H}",
                sample_size=inner.rt.image_sample_size, boxes_ok=ok, masks_ok=tracker.masks_ok,
                nonempty_masks=tracker.nonempty, launches=launches, expected=want,
                init_ms=tracker.init_ms,
                median_ms_per_frame=float(np.median(tracker.ms[ZOO_WARMUP:])),
                first_frame_ms=tracker.ms[0], build_s=build_s, sequence_s=run_s, **extra,
                host_syncs_per_frame=len(sites) / DIMP_SYNC_FRAMES,
                sync_sites=sorted(set(sites)), peak_memory_mb=peak_mb,
                profiled_frame_device_ms=dev_ms, profiled_frame_wall_ms=wall_s * 1e3,
                device_idle_share=1.0 - dev_ms / (wall_s * 1e3),
                profiled_frame_kernels=sum(e.count for e in rows),
                top_kernels=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                             for e in rows[:6]], card=card_line())
            if not ok or not tracker.masks_ok or launches != want:
                raise AssertionError(f"lwl_stm {name}: boxes ok {ok}, masks ok "
                                     f"{tracker.masks_ok}, launches {launches}")
            # over the sequence: an LWL update from frame_num 3 on, 3 GN steps each;
            # an STM commit where (frame_num - 1) % memory_skip_rate == 0
            want_extra = ({"memory_updates": ZOO_FRAMES - 2, "gn_steps": 3 * (ZOO_FRAMES - 2)}
                          if name == "lwl" else
                          {"commits": (ZOO_FRAMES - 1) // inner.rt.memory_skip_rate})
            if extra != want_extra:
                raise AssertionError(f"{name}: {extra}, want {want_extra}")
            lwl_stm_card_vs_cpu(dev, name, inner, seq)
            if name == LS_ENTRY:
                save_result(result_path(res_in, "DepthTrack", name, seq.name), res,
                            fmt=seq.save_fmt, delimiter=seq.save_delimiter,
                            time_style=seq.time_style)
            del tracker, inner
            torch.cuda.empty_cache()
        defer_entries([LS_ENTRY], root, seq_dir, res_in)
        lwl_vot_entry(dev, tmp)
    log("lwl_stm_phase", seconds=time.perf_counter() - t_phase, recipes=len(LWL_STM))


def lwl_stm_card_vs_cpu(dev, name: str, tracker, seq) -> None:
    """lwl or stm on the card (TF32 off) against the same weights on the
    CPU, where tests/test_torch_{lwl,stm}.py hold the runtimes against JAX:
    the card tracks CARD_VS_CPU_FRAME - 1 frames, the CPU takes its state,
    and both track the next (frame_num 11: an LWL update, an STM commit)."""
    import copy

    from mmtrack_torch.trackers.lwl_tracker import LWLTracker
    from mmtrack_torch.trackers.stm_tracker import STMTracker

    frames = _card_vs_cpu_frames(seq, CARD_VS_CPU_FRAME)
    cls = LWLTracker if name == "lwl" else STMTracker
    card = cls(tracker.model, dev, tracker.rt)
    cpu = cls(copy.deepcopy(tracker.model), "cpu", tracker.rt)
    card.initialize(frames[0], {"init_bbox": seq.gt[0].tolist()})
    for f in frames[1:-1]:
        card.track(f)
    cpu.state = tree_to(card.state, torch.device("cpu"))
    got = card.track(frames[-1])
    t0 = time.perf_counter()
    want = cpu.track(frames[-1])
    cpu_s = time.perf_counter() - t0
    diff = dict(box_max_abs_diff_px=float(np.abs(np.subtract(got["target_bbox"],
                                                             want["target_bbox"])).max()),
                max_prob_abs_diff=abs(got["best_score"] - want["best_score"]),
                mask_pixels_differing=float((got["segmentation"] != want["segmentation"]).mean()),
                mask_pixels_on=float(want["segmentation"].mean()))
    same = True
    if name == "lwl":
        f_card, f_cpu = card.state["filter"].cpu(), cpu.state["filter"]
        diff["filter_rel_diff"] = float((f_card - f_cpu).abs().max() / f_cpu.abs().max())
        diff["updated_frames"] = (card.updates, cpu.updates)
        same = diff["filter_rel_diff"] <= LS_FILTER_REL_BAR and cpu.updates == 1
    else:
        diff["commits"] = (card.commits, cpu.commits)
        same = cpu.commits == 1
    log("lwl_stm_card_vs_cpu", tracker=name, frame=CARD_VS_CPU_FRAME, **diff,
        box_bar=MDNET_BOX_BAR, prob_bar=SCORE_BAR, mask_bar=LS_MASK_BAR,
        filter_rel_bar=LS_FILTER_REL_BAR, cpu_frame_s=cpu_s,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    if not (same and diff["box_max_abs_diff_px"] <= MDNET_BOX_BAR
            and diff["max_prob_abs_diff"] <= SCORE_BAR
            and diff["mask_pixels_differing"] <= LS_MASK_BAR):
        raise AssertionError(f"{name} card vs CPU beyond bars: {diff}")


def lwl_vot_entry(dev, tmp: str) -> None:
    """`python -m mmtrack_torch.eval.vot_entry` with MMTRACK_TRACKER=lwl and
    MMTRACK_MASK=1 on the card, in its own process, answering a mask
    session of LS_VOT_FRAMES 640x480 frames: exit 0, every state a
    full-frame mask, and the masks equal to the same session's in process
    (the init mask reaches the tracker verbatim; Alpha-Refine is not
    built)."""
    root = os.path.join(tmp, "vot_lwl")
    os.makedirs(root)
    colors, depths, (x, y, w, h) = vot_sequence(root, LS_VOT_FRAMES)
    init_mask = np.zeros((int(h), int(w)), np.uint8)
    init_mask[int(h) // 4:, :] = 1                   # not a rectangle's box
    script = trax_script(colors, depths, _encode_region(Mask(int(x), int(y), init_mask)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.update(MMTRACK_TRACKER="lwl", MMTRACK_MASK="1")
    env.pop("MMTRACK_DEVICE", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mmtrack_torch.eval.vot_entry"], cwd=tmp,
                          env=env, input=script, capture_output=True, text=True, timeout=600)
    entry_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"lwl VOT entry exited {proc.returncode}: {proc.stderr[-3000:]}")
    got = [_decode_region(ln.split('"')[1]) for ln in proc.stdout.splitlines()
           if ln.startswith("@@TRAX:state")]
    built = []

    def refine_factory():
        built.append(1)
        raise AssertionError("Alpha-Refine built for a mask tracker")

    fout = io.StringIO()
    run_vot_exp(lambda: build_tracker("lwl", device=dev), channels="rgbd", dtype="rgbcolormap",
                fin=io.StringIO(script), fout=fout, mask=True, refine_factory=refine_factory)
    want = [_decode_region(ln.split('"')[1]) for ln in fout.getvalue().splitlines()
            if ln.startswith("@@TRAX:state")]
    H, W = VOT_HW
    ok = len(got) == len(want) == LS_VOT_FRAMES and all(
        isinstance(s, Mask) and (s.x, s.y) == (0, 0) and s.mask.shape == (H, W) for s in got[1:])
    equal = ok and all(np.array_equal(a.mask, b.mask) for a, b in zip(got[1:], want[1:]))
    log("lwl_vot_entry", tracker="lwl", protocol="mask", frames=LS_VOT_FRAMES,
        frame=f"{W}x{H}", seconds=entry_s, states=len(got), states_ok=ok,
        masks_equal_in_process=equal, refiner_built=bool(built),
        mask_area_fraction=[float(s.mask.mean()) for s in got[1:]] if ok else None)
    if not ok or not equal or built:
        raise AssertionError(f"lwl VOT entry: states ok {ok}, masks equal {equal}")


# phase 16: the zoo's training scripts, (script, stage, B): half the
# scripts' batches, to leave the script's time for phases 18-19 (a step's
# ms at B=32, MixFormer-L's at B=8 and APFNet's at B=16 are in PERF.md);
# APFNet's stage-3 step peaked at 27.3 GiB at B=8 (1,024 patches)
ZOO_TRAIN = (("dimp", "", 16), ("det_dimp", "", 16), ("stark", "bbox", 16),
             ("stark", "score", 16), ("mixformer", "bbox", 4), ("mixformer", "score", 4),
             ("siamfc", "", 16), ("mdnet", "", 16), ("apfnet", "1", 8), ("apfnet", "2", 8),
             ("apfnet", "3", 8), ("kys", "", 16), ("lwl", "", 16), ("lwl_box", "", 16))
ZOO_TRAIN_STEPS = 2                 # timed steps; the second is reported
APFNET_ATTRIBUTE = 2                # the attribute APFNet's stage 1 trains
TRAIN_CARD_VS_CPU_B = 1
TRAIN_LOSS_CARD_VS_CPU_BAR = 1e-4   # one f32 step, card (TF32 off) vs CPU: each loss term
# the scripts stepped on the card and on the CPU, and their loss terms held to the bar
TRAIN_CARD_VS_CPU = (("dimp", ("Loss/total",)), ("mdnet", ("Loss/total",)),
                     ("kys", ("Loss/test_clf", "Loss/is_target")), ("lwl", ("Loss/segm",)))
ZOO_TRAIN_ENTRIES = (["--script", "det_dimp", "--batch", "2", "--samples", "2"],
                     ["--script", "apfnet", "--stage", "1", "--attribute", "2", "--batch", "2",
                      "--samples", "2"])


def zoo_train_batches(script: str, B: int, n: int, seed: int = 0) -> list:
    """`n` batches of the synthetic corpus through the entry's own loader
    and crops (train/run.py::zoo_loader)."""
    from mmtrack_torch.train.run import zoo_loader

    cfg = vipt_experiment_config("deep_rgbd")
    cfg.TRAIN.BATCH_SIZE, cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = B, B * n
    return list(zoo_loader(script, [SyntheticVideoDataset(n_sequences=8, n_frames=60)], None,
                           cfg, seed))


def train_card_vs_cpu(dev, cfg, script: str, terms) -> None:
    """One f32 step of `script` on the card and on the CPU from the same
    seeded weights, batch and draws: each loss term in `terms` within
    TRAIN_LOSS_CARD_VS_CPU_BAR relative; the trained leaves' relative L2
    after the step printed."""
    from mmtrack_torch.train import run
    from mmtrack_torch.train.dimp_actor import N_PROPOSALS
    from mmtrack_torch.train.zoo_actors import mdnet_box_noise

    B = TRAIN_CARD_VS_CPU_B
    batch = zoo_train_batches(script, B, 1, seed=1)[0]
    gen = torch.Generator().manual_seed(1)
    draws = {"dimp": lambda: {"noise": torch.randn((B, N_PROPOSALS, 4), generator=gen)},
             "mdnet": lambda: {"noise": mdnet_box_noise(gen, B, 32, 96, "cpu")}}
    kw = draws.get(script, dict)()
    after = []
    for d in (dev, torch.device("cpu")):
        model = run.build_zoo_model(script, "", 0, d)
        trainable = run.zoo_trainable_mask(model, script, "")
        state = run.train_state(model, cfg, 1000, trainable)
        t0 = time.perf_counter()
        _, stats = run.make_zoo_step(script, "", 0, torch.float32)(state, batch, **kw)
        stats = {k: float(v) for k, v in stats.items()}
        after.append((stats, {k: p.detach().cpu() for k, p in model.named_parameters()
                              if p.requires_grad}, time.perf_counter() - t0))
    (card_stats, card_p, _), (cpu_stats, cpu_p, cpu_s) = after
    rel = {k: abs(card_stats[k] - cpu_stats[k]) / abs(cpu_stats[k]) for k in cpu_stats}
    d2 = sum(float(((card_p[k] - cpu_p[k]) ** 2).sum()) for k in cpu_p)
    n2 = sum(float((cpu_p[k] ** 2).sum()) for k in cpu_p)
    log("zoo_train_card_vs_cpu", script=script, B=B, card=card_stats, cpu=cpu_stats, rel=rel,
        bar=TRAIN_LOSS_CARD_VS_CPU_BAR, trained_params_rel_l2=(d2 / n2) ** 0.5,
        cpu_step_s=cpu_s)
    if any(rel[k] > TRAIN_LOSS_CARD_VS_CPU_BAR for k in terms):
        raise AssertionError(f"{script} step card vs CPU: {rel}")


def zoo_train_path(dev, side=None) -> None:
    """Phase 16: the dimp, det_dimp, stark (bbox, score), mixformer (bbox,
    score), siamfc, mdnet, apfnet (stages 1-3), kys, lwl and lwl_box
    scripts of train/run.py at full width, f32 (TF32 off) on seeded
    weights: ZOO_TRAIN_STEPS steps of each on synthetic batches through
    the entry's own model, trainable set, optimizer and step, then one
    profiled step; the five kernels launch 0 times. One dimp, mdnet, kys
    and lwl step each on the card against the CPU, and `python -m
    mmtrack_torch.train.run --script det_dimp` and `--script apfnet
    --stage 1` each in its own process."""
    from mmtrack_torch.train import run
    from mmtrack_torch.train.optim import count_trainable

    cfg = vipt_experiment_config("deep_rgbd")
    t_phase = time.perf_counter()
    for script, stage, B in ZOO_TRAIN:
        t_script = time.perf_counter()
        batches = zoo_train_batches(script, B, ZOO_TRAIN_STEPS)
        loader_s = time.perf_counter() - t_script
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = run.build_zoo_model(script, stage, 0, dev)
        trainable = run.zoo_trainable_mask(model, script, stage, APFNET_ATTRIBUTE)
        state = run.train_state(model, cfg, 1000, trainable)
        step = run.make_zoo_step(script, stage, 0, torch.float32)
        reset_launches(*KERNEL_COUNTERS)
        ms, losses = [], []
        for batch in batches[:ZOO_TRAIN_STEPS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, stats = step(state, batch)
            losses.append(float(stats["Loss/total"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts(KERNEL_COUNTERS)
        # the card's activity alone: the profiled steps took two thirds of
        # this phase's seconds, half of that for the host's op events (which
        # makes room for phase 21); its numbers go under card_only_* names
        rows, wall_s = profile_window(lambda: step(state, batches[-1]), 1, host_ops=False)
        dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
        n_trained = count_trainable(model, trainable) if trainable is not None else sum(
            p.numel() for p in model.parameters())
        ok = all(math.isfinite(v) for v in losses) and not any(launches.values())
        log("zoo_train", script=script, stage=stage or None, B=B, dtype="f32",
            attribute=APFNET_ATTRIBUTE if (script, stage) == ("apfnet", "1") else None,
            crops=[batches[0]["template"].shape[1], batches[0]["search"].shape[1]],
            trainable_params=n_trained, step_ms=ms,
            median_step_ms=float(np.median(ms[1:])), first_loss=losses[0], last_loss=losses[-1],
            samples_per_s=B / (float(np.median(ms[1:])) / 1e3),
            peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20, launches=launches,
            profiler=("CUDA activity alone: not comparable with a CPU + CUDA window's "
                      "profiled_step_* and device_idle_share"),
            card_only_step_device_ms=dev_ms, card_only_step_wall_ms=wall_s * 1e3,
            card_only_idle_share=1.0 - dev_ms / (wall_s * 1e3),
            card_only_step_kernels=sum(e.count for e in rows),
            card_only_top_kernels=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                                   for e in rows[:5]], loader_s=loader_s,
            seconds=time.perf_counter() - t_script, card=card_line())
        if not ok:
            raise AssertionError(f"zoo_train {script} {stage}: losses {losses}, "
                                 f"launches {launches}")
        del model, state, step, batches
        torch.cuda.empty_cache()

    if side is not None:            # work of its own beside the CPU-bound checks below
        side()
    # the entries in their own processes, beside the card-vs-CPU steps (untimed)
    tmp = tempfile.mkdtemp()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_entry = time.perf_counter()
    entries = [(args, subprocess.Popen(
        [sys.executable, "-m", "mmtrack_torch.train.run", "--synthetic", "--epochs", "1",
         "--save_dir", os.path.join(tmp, str(i))] + args, cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for i, args in enumerate(ZOO_TRAIN_ENTRIES)]
    try:
        for script, terms in TRAIN_CARD_VS_CPU:
            train_card_vs_cpu(dev, cfg, script, terms)
        for i, (args, entry) in enumerate(entries):
            out, err = entry.communicate(timeout=300)
            stage = args[args.index("--stage") + 1] if "--stage" in args else None
            run_dir = f"{args[1]}-{stage}" if stage else args[1]
            ckpt = os.path.join(tmp, str(i), run_dir, "checkpoints", "epoch_0001.pt")
            done = os.path.exists(ckpt)
            log("zoo_train_entry", args=args, seconds=time.perf_counter() - t_entry,
                returncode=entry.returncode, checkpoint=done, stdout=out.splitlines()[-4:])
            if entry.returncode != 0 or not done:
                raise AssertionError(f"train entry {args} exited {entry.returncode}: "
                                     f"{err[-3000:]}")
    finally:
        for _, entry in entries:
            if entry.poll() is None:
                entry.kill()
                entry.communicate()
        shutil.rmtree(tmp)
    log("zoo_train_phase", seconds=time.perf_counter() - t_phase, scripts=len(ZOO_TRAIN))


DEMO_TIMEOUT_S = 600


def start_learning_demo() -> dict:
    """Phase 17's process: `python -m mmtrack_torch.train.learning_demo
    --lwl_only` on the card, in its own session (a timeout
    ends the demo and the training run it started)."""
    tmp = tempfile.mkdtemp()
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "demo.json")
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "mmtrack_torch.train.learning_demo",
                             "--lwl_only", "--out", out,
                             "--workdir", os.path.join(tmp, "ws")],
                            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    return {"proc": proc, "tmp": tmp, "out": out, "t0": time.perf_counter()}


def learning_demo_path(demo: dict) -> None:
    """Phase 17: the learning demo's LWL phase started by
    start_learning_demo (during phase 16's CPU-bound checks); it must exit
    0 with `improved` true."""
    proc, tmp, out, t_phase = demo["proc"], demo["tmp"], demo["out"], demo["t0"]
    try:
        stdout, stderr = proc.communicate(
            timeout=max(1.0, DEMO_TIMEOUT_S - (time.perf_counter() - t_phase)))
        phase = None
        if os.path.exists(out):
            with open(out) as f:
                phase = json.load(f).get("lwl_segmentation")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
        shutil.rmtree(tmp)
    if phase is None:
        raise AssertionError(f"learning demo --lwl_only exited {proc.returncode} without its "
                             f"result: {stderr[-3000:]}")
    keys = ("auc", "mean_iou", "sr50", "crop_launches", "masks")
    log("learning_demo", demo_phase="lwl_segmentation", returncode=proc.returncode,
        improved=phase["improved"], epochs=phase["epochs"],
        before={k: phase["before"].get(k) for k in keys},
        after={k: phase["after"].get(k) for k in keys},
        partial_masks_after=phase["after"].get("masks", {}).get("partial", 0),
        epoch_losses=phase["epoch_losses"], params_sha256=phase["params_sha256"],
        train_seconds=phase["train_seconds"], demo_seconds=phase["seconds"],
        train_epochs=[ln for ln in stdout.splitlines() if ln.startswith("epoch ")],
        card=card_line())
    if proc.returncode != 0 or not phase["improved"]:
        raise AssertionError(f"learning demo --lwl_only exited {proc.returncode}, improved "
                             f"{phase['improved']}: {stderr[-3000:]}")
    log("learning_demo_phase", seconds=time.perf_counter() - t_phase)


SUITE_RECIPES = ("vipt_deep_rgbd", "siamfc", "mosse")
DEMO_FRAMES = 5
TRACE_STEPS = 3                     # main-path steps under utils/profiling.py::trace_profile
TRACE_KERNELS = (CROP_KERNEL, GEMM_KERNEL, LAYERNORM_KERNEL, ATTENTION_KERNELS[0])
POLYGON_BAR = 1e-4                  # native polygon_iou vs its numpy plain version
ENTRY_TIMEOUT_S = 420


def entry_env(**extra) -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **extra)


def start(cmd: list, cwd: str, **env) -> subprocess.Popen:
    """`python -m <cmd>` in its own session (a timeout ends it and what it
    started)."""
    return subprocess.Popen([sys.executable, "-m", *cmd], cwd=cwd, env=entry_env(**env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def stop(procs: dict) -> None:
    """End every process of `procs` still running, and what it started."""
    for proc in procs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()


def finish(procs: dict, t0: float) -> dict:
    """name -> stdout of each process, once all have exited within
    ENTRY_TIMEOUT_S of t0; a failure or a timeout raises with the
    process's stderr."""
    outs = {}
    try:
        for name, proc in procs.items():
            left = max(1.0, ENTRY_TIMEOUT_S - (time.perf_counter() - t0))
            out, err = proc.communicate(timeout=left)
            if proc.returncode != 0:
                raise AssertionError(f"{name} exited {proc.returncode}: {err[-3000:]}")
            outs[name] = out
    finally:
        stop(procs)
    return outs


def dashboard_session(proc) -> dict:
    """The demo's dashboard, read over HTTP on localhost while the demo
    waits paused: /state, /data of every title, one step, then resume."""
    import urllib.request

    line = proc.stdout.readline()
    m = re.search(r"(http://127\.0\.0\.1:\d+/)", line)
    if not m:
        raise AssertionError(f"demo printed no dashboard URL: {line!r}")
    url = m.group(1)

    def get(path):
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return json.loads(r.read())

    def control(action):
        req = urllib.request.Request(url + "control", method="POST",
                                     data=json.dumps({"action": action}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def wait(pred):
        deadline = time.perf_counter() + 300
        while time.perf_counter() < deadline:
            state = get("state")
            if pred(state):
                return state
            time.sleep(0.05)
        raise AssertionError(f"dashboard state never reached: {state}")

    first = wait(lambda s: s["frame"] == 1 and "Status" in s["titles"])
    data = {t: get("data?title=" + t.replace(" ", "%20")) for t in first["titles"]}
    control("step")
    second = wait(lambda s: s["frame"] == 2)
    control("resume")
    return {"paused_at_frame_1": first["paused"], "titles": sorted(first["titles"]),
            "status": data["Status"]["info"], "tracking_jpeg_bytes": len(data["Tracking"]["jpeg"]),
            "score_map_shape": np.shape(data["Score Map"]["values"]) if "Score Map" in data
            else None, "stepped_to_frame": second["frame"]}


def zip_members(path: str) -> dict:
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def submission_check(suite_root: str, tmp: str, recipe: str) -> dict:
    """transform_results got10k and trackingnet over copies of `recipe`'s
    result tree: every sequence's boxes in both zips, truncated to ints."""
    from mmtrack_torch.eval import transform_results

    src = os.path.join(suite_root, "DepthTrack", recipe)
    names = sorted(f[:-4] for f in os.listdir(src) if f.endswith(".txt"))
    want = {n: np.loadtxt(os.path.join(src, f"{n}.txt"), delimiter=",").astype(int)
            for n in names}
    out = {}
    for server, member in (("got10k", "{n}/{n}_001.txt"), ("trackingnet", "{n}.txt")):
        root = os.path.join(tmp, server)
        shutil.copytree(src, os.path.join(root, server, recipe))
        with io.StringIO() as buf:
            stdout, sys.stdout = sys.stdout, buf
            try:
                transform_results.main([server, "--results-root", root, "--config", recipe])
            finally:
                sys.stdout = stdout
            raw_zip, sub_zip = buf.getvalue().split()
        members = zip_members(sub_zip)
        got = {n: np.loadtxt(io.BytesIO(members[member.format(n=n)]), delimiter=",", dtype=int)
               for n in names}
        ok = all(np.array_equal(got[n], want[n]) for n in names)
        if server == "got10k":
            ok = ok and all(f"{n}/{n}_time.txt" in members for n in names)
        out[server] = {"members": sorted(members), "raw_members": len(zip_members(raw_zip)),
                       "boxes_equal": ok}
        if not ok:
            raise AssertionError(f"transform_results {server}: {out[server]}")
    return out


def polygon_check() -> dict:
    """native.py's polygon_iou (g++ on this machine) against its plain
    version on seeded polygons, and batch_iou_xywh against metrics'."""
    from mmtrack_torch import native
    from mmtrack_torch.eval.metrics import iou_xywh

    t0 = time.perf_counter()
    native.load_region_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    polys = []
    for _ in range(6):
        c = rng.uniform(20, 80, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(3, 8)))
        r = rng.uniform(5, 30, len(ang))
        polys.append(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1))
    diffs = [abs(native.polygon_iou(a, b) - native.polygon_iou_plain(a, b))
             for a in polys for b in polys]
    a = np.concatenate([rng.uniform(0, 50, (20000, 2)), rng.uniform(0, 30, (20000, 2))], 1)
    b = np.concatenate([rng.uniform(0, 50, (20000, 2)), rng.uniform(0, 30, (20000, 2))], 1)
    batch_diff = float(np.abs(native.batch_iou_xywh(a, b) - iou_xywh(a, b)).max())
    out = {"library": os.path.basename(native.library_path()), "build_s": build_s,
           "pairs": len(diffs), "max_abs_diff_vs_plain": max(diffs), "bar": POLYGON_BAR,
           "batch_iou_max_abs_diff": batch_diff}
    if max(diffs) > POLYGON_BAR or batch_diff > 1e-12:
        raise AssertionError(f"native region library vs plain: {out}")
    return out


def trace_check(dev, cfg, rt, frames, box0, tmp: str) -> dict:
    """TRACE_STEPS steps of the main path (eager, bf16, B=16) under
    utils/profiling.py::trace_profile: the Chrome trace names the crop
    kernel and the half-blocks' kernels, and the wrappers count one crop,
    9 attention and 12 MLP half-blocks a step."""
    from mmtrack_torch.utils.profiling import trace_profile

    model = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    tracker = BatchedViPTTracker(model, dev, rt, scan=partial(vipt_track_scan_batched, rt, model))
    tracker.initialize(frames[0], box0)
    tracker.track(frames[1])
    torch.cuda.synchronize()
    counters = (attn_block_fused, mlp_block_fused, crop_resize_normalized)
    reset_launches(*counters)
    with trace_profile(os.path.join(tmp, "trace")) as prof:
        for t in range(TRACE_STEPS):
            tracker.track(frames[2 + t])
        torch.cuda.synchronize()
    launches = launch_counts(counters)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    named = {k: any(k in name for name in kernels) for k in TRACE_KERNELS}
    want = {"attn_block_fused": 9 * TRACE_STEPS, "mlp_block_fused": 12 * TRACE_STEPS,
            "crop_resize_normalized": TRACE_STEPS}
    out = {"steps": TRACE_STEPS, "trace_mb": os.path.getsize(prof.trace_path) / 2 ** 20,
           "kernel_events": sum(e.get("cat") == "kernel" for e in events),
           "distinct_kernels": len(kernels), "named": named, "launches": launches,
           "expected": want}
    del tracker, model
    torch.cuda.empty_cache()
    if launches != want or not all(named.values()):
        raise AssertionError(f"trace_profile: {out}")
    return out


def host_tools_path(dev, cfg, rt, frames, box0) -> dict:
    """Phase 18: the host tools. Returns the kernel launches counted in
    this process (the traced main-path steps)."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        data = os.path.join(tmp, "DepthTrack")
        ope_fixture(data, n_seqs=1)
        common = ["--dataset", "DepthTrack", "--dataset_root", data]
        t0 = time.perf_counter()
        procs = {"suite": start(["mmtrack_torch.eval.benchmark_suite", "--trackers",
                                 ",".join(SUITE_RECIPES), "--results_root",
                                 os.path.join(tmp, "suite")] + common, tmp)}
        procs.update({name: start(["mmtrack_torch.eval.run_ope", "--tracker", name, "--analyze",
                                   "--results_root", os.path.join(tmp, "ope")] + common, tmp)
                      for name in SUITE_RECIPES})
        demo = start(["mmtrack_torch.demo", "--tracker", "vipt_deep_rgbd", "--frames",
                      str(DEMO_FRAMES), "--dashboard", "--pause", "--out",
                      os.path.join(tmp, "demo")], tmp, PYTHONUNBUFFERED="1")
        procs["demo"] = demo
        try:
            session = dashboard_session(demo)
        except BaseException:
            stop(procs)
            raise
        polygons = polygon_check()
        trace = trace_check(dev, cfg, rt, frames, box0, tmp)
        outs = finish(procs, t0)
        entries_s = time.perf_counter() - t0
        suite = json.load(open(os.path.join(tmp, "suite", "DepthTrack", "suite_report.json")))
        own = {}
        for name in SUITE_RECIPES:
            rep = json.load(open(os.path.join(tmp, "ope", "DepthTrack", f"{name}_report.json")))
            own[name] = {"SR": round(rep["ope"]["success_auc"] * 100, 2),
                         "PR": round(rep["ope"]["precision_20px"] * 100, 2),
                         "F": round(rep["fscore"]["fscore"], 4)}
        frames_shown = [ln for ln in outs["demo"].splitlines() if ln.startswith("frame ")]
        demo_files = sorted(os.listdir(os.path.join(tmp, "demo")))
        subs = submission_check(os.path.join(tmp, "suite"), tmp, "mosse")
        log("host_tools", suite=suite, run_ope_reports=own, suite_equals_run_ope=suite == own,
            entries_s=entries_s, demo={**session, "frames_tracked": len(frames_shown),
                                       "files": len(demo_files)},
            transform_results=subs, polygon_iou=polygons, trace_profile=trace, card=card_line())
        if suite != own or len(frames_shown) != DEMO_FRAMES - 1 or \
                len(demo_files) != DEMO_FRAMES + 1 or not session["paused_at_frame_1"]:
            raise AssertionError(f"host tools: suite {suite} vs run_ope {own}; demo {session}, "
                                 f"{frames_shown}, {demo_files}")
    finally:
        shutil.rmtree(tmp)
    log("host_tools_phase", seconds=time.perf_counter() - t_phase)
    return trace["launches"]


DDP_STEP_LAUNCHES = {"flash_mhsa_qkv": 8, "attn_block_fused": 1, "mlp_block_fused": 1,
                     "crop_resize_normalized": 0}
# the sharded tracker's initialize + first track (a capture: SCAN_WARMUP_STEPS
# eager steps + the captured step) and track_split (a replay, uncounted)
DDP_TRACK_LAUNCHES = {"flash_mhsa_qkv": 0, "attn_block_fused": 9 * (SCAN_WARMUP_STEPS + 1),
                      "mlp_block_fused": 12 * (SCAN_WARMUP_STEPS + 1),
                      "crop_resize_normalized": 1 + SCAN_WARMUP_STEPS + 1}
# train.run --distributed vs one process: the loss (Loss/total, the mean
# over the two steps); the terms are printed. The entries run at the
# configs' own f32. The first step agrees to 8e-8 (the dry run's); Adam's
# first update, ~lr sign(g), turns gradients within rounding of zero into
# +-lr differences (7.4e-4 on prompt elements at bf16), which move the
# second step: at bf16 deep_rgbd's loss parted by 1.4e-3 (GIoU 8.5e-3, L1
# 2.1e-2), at f32 by 3.5e-4 (GIoU 2.5e-3, L1 4.5e-3; one card)
DDP_ENTRY_LOSS_BAR = 1e-3
DDP_ENTRIES = {"vipt": ["--config", "deep_rgbd"], "siamfc": ["--script", "siamfc"]}
DDP_ENTRY_SAMPLES = 2 * TRAIN_B     # two steps at B=32


def ddp_path() -> dict:
    """Phase 19: the data-parallel layer on the one card. Returns the
    kernel launches its ranks counted."""
    from mmtrack_torch.parallel import dryrun

    t_phase = time.perf_counter()
    launches = dict.fromkeys(DDP_STEP_LAUNCHES, 0)
    note = ("gloo on one shared card stages every collective through the host: these times "
            "say nothing about NCCL across cards")
    for n, backend in ((2, "gloo"), (1, "nccl")):
        t0 = time.perf_counter()
        out = dryrun.run(n)
        log("ddp_dryrun", **out, seconds=time.perf_counter() - t0, note=note if n > 1 else None,
            card=card_line())
        ok = (out["backend"] == backend and out["batch"] == TRAIN_B
              and all(r == DDP_STEP_LAUNCHES for r in out["step_launches_per_rank"])
              and all(r == DDP_TRACK_LAUNCHES for r in out["track_launches_per_rank"]))
        if not ok:
            raise AssertionError(f"dry run over {n} ranks: {out}")
        for counts in out["step_launches_per_rank"] + out["track_launches_per_rank"]:
            for k, v in counts.items():
                launches[k] += v

    tmp = tempfile.mkdtemp()
    try:
        data = os.path.join(tmp, "DepthTrack")
        ope_fixture(data)
        torchrun = ["torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m"]
        t0 = time.perf_counter()
        procs = {}
        for script, args in DDP_ENTRIES.items():
            train = ["mmtrack_torch.train.run", "--synthetic", "--epochs", "1", "--batch",
                     str(TRAIN_B), "--samples", str(DDP_ENTRY_SAMPLES)] + args
            procs[f"{script}_one"] = start(train + ["--save_dir", os.path.join(tmp, script, "one")],
                                           tmp)
            procs[f"{script}_ddp"] = start(torchrun + train + [
                "--distributed", "--save_dir", os.path.join(tmp, script, "ddp")], tmp)
        ope = ["mmtrack_torch.eval.run_ope", "--tracker", "mosse", "--dataset", "DepthTrack",
               "--dataset_root", data, "--results_root"]
        procs["ope_one"] = start(ope + [os.path.join(tmp, "ope_one")], tmp)
        procs["ope_ddp"] = start(torchrun + ope + [os.path.join(tmp, "ope_ddp")], tmp)
        outs = finish(procs, t0)
        entries_s = time.perf_counter() - t0
        for script in DDP_ENTRIES:
            logs, ckpts = {}, {}
            for kind in ("one", "ddp"):
                d = os.path.join(tmp, script, kind)
                d = os.path.join(d, *os.listdir(d))          # <script>-<config or stage>
                logs[kind] = [json.loads(ln) for ln in open(os.path.join(d, "logs", "train.jsonl"))]
                ckpts[kind] = sorted(os.listdir(os.path.join(d, "checkpoints")))
            terms = [k for k in logs["one"][0] if k.startswith("Loss")]
            rel = {k: abs(logs["ddp"][0][k] - logs["one"][0][k]) / abs(logs["one"][0][k])
                   for k in terms}
            loss_rel = rel["Loss/total"]
            done = [ln for ln in outs[f"{script}_ddp"].splitlines() if ln.startswith("done:")]
            backend = [ln for ln in outs[f"{script}_ddp"].splitlines() if "backend" in ln]
            log("ddp_train_entry", script=script, B=TRAIN_B, steps=DDP_ENTRY_SAMPLES // TRAIN_B,
                one=logs["one"][0], ddp=logs["ddp"][0], rel=rel, bar=DDP_ENTRY_LOSS_BAR,
                log_lines={k: len(v) for k, v in logs.items()}, checkpoints=ckpts,
                done_lines=len(done), ranks=backend, card=card_line())
            if (loss_rel > DDP_ENTRY_LOSS_BAR or len(logs["ddp"]) != 1
                    or ckpts["ddp"] != ["epoch_0001.pt"] or len(done) != 1):
                raise AssertionError(f"train.run --distributed {script}: rel {rel}, logs "
                                     f"{logs}, checkpoints {ckpts}, done {done}")
        one = os.path.join(tmp, "ope_one", "DepthTrack", "mosse")
        two = os.path.join(tmp, "ope_ddp", "DepthTrack", "mosse")
        names = sorted(f for f in os.listdir(one) if f.endswith(".txt"))
        same = names == sorted(f for f in os.listdir(two) if f.endswith(".txt")) and all(
            open(os.path.join(one, f), "rb").read() == open(os.path.join(two, f), "rb").read()
            for f in names)
        log("ddp_run_ope", tracker="mosse", sequences=len(names), ranks=2, files_equal=same,
            entries_s=entries_s, card=card_line())
        if not same or len(names) != OPE_SEQS:
            raise AssertionError(f"run_ope over 2 ranks: {names}, equal {same}")
    finally:
        shutil.rmtree(tmp)
    log("ddp_phase", seconds=time.perf_counter() - t_phase)
    return launches


# phase 20: the last modules (ViPT's CORNER and MLP heads on the main path,
# STARK's RepVGG-A0 and Swin-T trunks, Alpha-Refine's training step,
# MobileNetV3 and the rpe / talking-heads attentions)
HB_HEADS = ("CORNER", "MLP")
HB_STEPS = 8                        # counted eager steps a head, after one warm-up step
HB_GRAPH_CHUNKS = 2                 # timed replays of a SCAN_T-step chunk graph
HB_MAP_REL_BAR = 0.05               # score_map / max_score kernels vs plain, of the plain max
HB_F32_BAR = 1e-4                   # f32 card (TF32 off) vs CPU: each key, of the CPU's max
HB_TRUNKS = ("repvgg_a0", "swin_tiny")
HB_FUSE_REL_BAR = 1e-4              # RepVGG deploy vs three-branch on the card, of the max
AR_B, AR_SIZE = 8, 256
AR_LOSS_REL_BAR = 1e-4              # the Alpha-Refine step's loss terms, card vs CPU
HB_MODULE_REL_BAR = 1e-4            # MobileNetV3 / attentions card vs CPU, of the max


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|, on the host."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def head_path(dev, rt, frames, box0, head: str) -> dict:
    """One head at full width, bf16, B=16 on phase 3's frames: the eager
    step loop (launches per step), a chunk of SCAN_T steps as one CUDA
    graph, the kernels against their plain versions, an f32 forward on the
    card against the CPU. Returns the launches counted."""
    cfg = vipt_experiment_config("deep_rgbd")
    cfg.MODEL.HEAD.TYPE = head
    model = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    tracker = BatchedViPTTracker(model, dev, rt, scan=partial(vipt_track_scan_batched, rt, model))
    tracker.initialize(frames[0], box0)
    tracker.track(frames[1])
    torch.cuda.synchronize()
    reset_launches(*SCAN_COUNTERS)
    tracker.initialize(frames[0], box0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    boxes = [tracker.track(frames[t])[0] for t in range(1, HB_STEPS + 1)]
    eager_s = time.perf_counter() - t0
    eager = scan_counts()
    want = {k: n * HB_STEPS for k, n in SCAN_PER_STEP.items()}
    want["crop_resize_normalized"] += 1                       # the init's template crop
    inside = boxes_inside(np.stack(boxes))

    chunk = frames[1:SCAN_T + 1]
    with torch.inference_mode():
        graph = make_track_scan(rt, model, dev)
        state = vipt_init_state(rt, frames[0], torch.from_numpy(box0))
        graph(state, chunk)                                       # warm-up + capture + replay
        torch.cuda.synchronize()
        before = scan_counts()
        t0 = time.perf_counter()
        for _ in range(HB_GRAPH_CHUNKS):
            _, gboxes, _ = graph(state, chunk)
        gboxes = gboxes.cpu()
        graph_s = time.perf_counter() - t0
    replayed = {k: v - before[k] for k, v in scan_counts().items()}
    counted = scan_counts()

    # the same forward with the kernels and with their plain versions, and at f32 card vs CPU
    plain = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0, use_kernels=False)
    mean, std = torch.from_numpy(MEAN_6CH).to(dev), torch.from_numpy(STD_6CH).to(dev)
    st = tracker.state
    search, _ = crop_resize_normalized_plain(frames[HB_STEPS], st["box"], rt.search_factor,
                                             rt.search_size, mean, std)
    mask = generate_ctr_mask(rt.template_size // rt.stride, rt.ce_template_range, dev)
    # CORNER's and MLP's maps are distributions over 256 cells (values near
    # 1/256) and so is max_score: each is held relative to its own largest
    # value; the boxes (normalised, in (0, 1)) absolutely, as phase 6's
    keys = ("score_map", "pred_boxes", "max_score")
    with torch.inference_mode():
        vs_plain = {}
        for lens in (None, rt.ce_keep_lens):
            ok_, op = (m(st["template"], search, mask, lens) for m in (model, plain))
            vs_plain["ce_on" if lens else "ce_off"] = {
                "score_map_rel": _rel_max(ok_["score_map"], op["score_map"]),
                "max_score_rel": _rel_max(ok_["max_score"], op["max_score"]),
                "pred_boxes": (ok_["pred_boxes"].float() - op["pred_boxes"].float()
                               ).abs().max().item()}
    del plain, model, tracker, graph
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(5)
    z = torch.randn((2, rt.template_size, rt.template_size, 6), generator=g)
    x = torch.randn((2, rt.search_size, rt.search_size, 6), generator=g)
    outs = []
    for d in (dev, torch.device("cpu")):
        m = build_viptrack(cfg, dtype=torch.float32, device=d, seed=0)
        with torch.inference_mode():
            o = m(z.to(d), x.to(d), mask.to(d), None)
        outs.append({k: o[k].float().cpu() for k in keys})
        del m
    card_vs_cpu = {f"{k}_rel": _rel_max(outs[0][k], outs[1][k]) for k in keys}
    H, W = FRAME_HW
    log("heads_backbones_head", head=head, config="deep_rgbd", dtype="bf16", B=B,
        frame=f"{W}x{H}", eager_steps=HB_STEPS, eager_ms_per_step=eager_s / HB_STEPS * 1e3,
        graph_T=SCAN_T, graph_chunks=HB_GRAPH_CHUNKS,
        graph_ms_per_step=graph_s / (HB_GRAPH_CHUNKS * SCAN_T) * 1e3,
        launches=eager, expected=want,
        launches_per_step={k: (eager[k] - (k == "crop_resize_normalized")) / HB_STEPS
                           for k in eager},
        graph_replay_launches=replayed, boxes_inside=inside and boxes_inside(gboxes.numpy()),
        kernels_vs_plain=vs_plain, map_rel_bar=HB_MAP_REL_BAR, box_bar=MAP_BAR,
        f32_card_vs_cpu=card_vs_cpu, f32_rel_bar=HB_F32_BAR, card=card_line())
    if eager != want or any(replayed.values()) or not inside:
        raise AssertionError(f"{head} head: launches {eager} (want {want}), graph replay "
                             f"{replayed}, boxes inside {inside}")
    off = vs_plain["ce_off"]
    if (off["score_map_rel"] > HB_MAP_REL_BAR or off["max_score_rel"] > HB_MAP_REL_BAR
            or off["pred_boxes"] > MAP_BAR):
        raise AssertionError(f"{head} head: kernels vs plain {vs_plain}")
    if max(card_vs_cpu.values()) > HB_F32_BAR:
        raise AssertionError(f"{head} head: f32 card vs CPU {card_vs_cpu}")
    return counted


def trunk_path(dev, seq_dir: str, trunk: str) -> dict:
    """SPT (six_channel, 128 / 320, d = 256, 6 + 6 layers, f32) on `trunk`
    over phase 10's 640x480 sequence: median ms a frame and the crop
    launches; one forward card vs CPU. Returns the launches counted."""
    from mmtrack_torch.eval.datasets import load_sequence
    from mmtrack_torch.eval.ope import run_sequence
    from mmtrack_torch.models.stark import STARK
    from mmtrack_torch.trackers.stark_tracker import STARKRuntime, STARKTracker

    model = init_vipt_weights(STARK(six_channel=True, backbone_type=trunk), 0)
    cpu_model = init_vipt_weights(STARK(six_channel=True, backbone_type=trunk), 0).eval()
    seq = load_sequence(seq_dir, "DepthTrack")
    seq.dtype = TRACKER_REGISTRY["spt"].composition
    tracker = FrameRecorder(STARKTracker(model, dev, STARKRuntime()))
    reset_launches(*OPE_COUNTERS)
    res = run_sequence(tracker, seq)
    launches = ope_counts()
    want = {"attn_block_fused": 0, "mlp_block_fused": 0,
            "crop_resize_normalized": ZOO_FRAMES + tracker.updates}
    H, W = OPE_HW
    ok = zoo_boxes_ok("spt", res["boxes"], H, W)
    g = torch.Generator().manual_seed(6)
    z = torch.randn((1, 128, 128, 6), generator=g)
    x = torch.randn((1, 320, 320, 6), generator=g)
    with torch.inference_mode():
        card = model(z.to(dev), x.to(dev))["pred_boxes"].cpu()
        cpu = cpu_model(z, x)["pred_boxes"]
    diff = (card - cpu).abs().max().item()
    log("heads_backbones_trunk", tracker="spt", backbone_type=trunk, dtype="f32",
        frames=ZOO_FRAMES, frame=f"{W}x{H}", boxes_ok=ok, launches=launches, expected=want,
        median_ms_per_frame=float(np.median(tracker.ms[ZOO_WARMUP:])),
        first_frame_ms=tracker.ms[0], init_ms=tracker.init_ms,
        box_card_vs_cpu=diff, bar=HB_F32_BAR, card=card_line())
    if not ok or launches != want or diff > HB_F32_BAR:
        raise AssertionError(f"spt on {trunk}: boxes ok {ok}, launches {launches} (want "
                             f"{want}), card vs CPU {diff}")
    return launches


def repvgg_fuse_check(dev) -> None:
    """RepVGG-A0's deploy form (fuse_repvgg_params) against its three-branch
    form on the card, BN statistics drawn from a seed, at SPT's 320 search."""
    from mmtrack_torch.models.repvgg import fuse_repvgg_params, repvgg_a0

    three = init_vipt_weights(repvgg_a0(last_layer="stage3"), 3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in three.named_parameters():
            if name.endswith(("bn.weight", "rbr_identity.weight")):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith(("bn.bias", "rbr_identity.bias", "running_mean")):
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("running_var"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
    deploy = repvgg_a0(deploy=True, last_layer="stage3")
    deploy.load_state_dict(fuse_repvgg_params(three.state_dict()))
    x = torch.randn((2, 320, 320, 3), generator=g).to(dev)
    with torch.inference_mode():
        a = three.to(dev).eval()(x)["stage3"]
        b = deploy.to(dev).eval()(x)["stage3"]
    rel = _rel_max(b, a)
    log("heads_backbones_repvgg_fuse", shape=list(a.shape), deploy_vs_three_branch_rel=rel,
        bar=HB_FUSE_REL_BAR, card=card_line())
    if rel > HB_FUSE_REL_BAR:
        raise AssertionError(f"RepVGG fused vs three-branch: {rel}")


def ar_train_check(dev) -> int:
    """One f32 Alpha-Refine step (train/zoo_actors.py::make_ar_train_step,
    B = 8, input 256, mask_valid alternating) on the card and on the CPU
    from the same seeded weights and batch: each loss term within
    AR_LOSS_REL_BAR. Returns the xcorr launches of the card's step."""
    from mmtrack_torch.models.alpha_refine import build_alpha_refine
    from mmtrack_torch.train.zoo_actors import make_ar_train_step

    r = np.random.RandomState(8)
    masks = np.zeros((AR_B, AR_SIZE, AR_SIZE), np.float32)
    masks[:, 80:180, 60:200] = 1.0
    batch = {"template": r.uniform(-1, 1, (AR_B, AR_SIZE, AR_SIZE, 3)).astype(np.float32),
             "template_anno": np.tile(np.float32([[64.0, 64.0, 128.0, 128.0]]), (AR_B, 1)),
             "search": r.uniform(-1, 1, (AR_B, AR_SIZE, AR_SIZE, 3)).astype(np.float32),
             "search_anno": r.uniform(0.2, 0.4, (AR_B, 4)).astype(np.float32),
             "masks": masks, "mask_valid": np.float32([1, 0] * (AR_B // 2))}
    stats, launches = [], None
    for d in (dev, torch.device("cpu")):
        model = build_alpha_refine(AR_SIZE, seed=0).to(d).train()
        opt, sched = build_optimizer(model, lr=1e-4)
        reset_launches(depthwise_xcorr)
        t0 = time.perf_counter()
        _, s = make_ar_train_step()(TrainState(model, opt, sched), batch)
        stats.append(({k: float(v) for k, v in s.items()}, time.perf_counter() - t0))
        if d == dev:
            launches = launch_counts([depthwise_xcorr])["depthwise_xcorr"]
    (card, card_s), (cpu, cpu_s) = stats
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
    log("heads_backbones_ar_train", B=AR_B, input=AR_SIZE, dtype="f32", card=card, cpu=cpu,
        rel=rel, bar=AR_LOSS_REL_BAR, xcorr_launches=launches, card_step_s=card_s,
        cpu_step_s=cpu_s, card_name=card_line())
    if max(rel.values()) > AR_LOSS_REL_BAR or launches != 1:
        raise AssertionError(f"Alpha-Refine step card vs CPU {rel}, xcorr launches {launches}")
    return launches


def modules_check(dev) -> None:
    """MobileNetV3-Large at 256 x 256 and the rpe and talking-heads
    attentions at ViT-B's width over 8 x 8 + 16 x 16 tokens, f32, seeded
    weights: the card against the CPU within HB_MODULE_REL_BAR."""
    from mmtrack_torch.models.backbones import MOBILENET_LAYERS, mobilenetv3_large
    from mmtrack_torch.models.layers import Attention, AttentionTalkingHead

    g = torch.Generator().manual_seed(9)
    cases = (("mobilenetv3_large", lambda: mobilenetv3_large(),
              torch.randn((2, 256, 256, 3), generator=g)),
             ("attention_rpe", lambda: Attention(768, 12, rpe=True),
              torch.randn((2, 320, 768), generator=g)),
             ("attention_talking_head", lambda: AttentionTalkingHead(768, 12),
              torch.randn((2, 320, 768), generator=g)))
    rows = {}
    for name, build, x in cases:
        outs = []
        for d in (dev, torch.device("cpu")):
            m = init_vipt_weights(build(), 2).to(d).eval()
            with torch.inference_mode():
                o = m(x.to(d), MOBILENET_LAYERS) if name.startswith("mobilenet") else m(x.to(d))
            o = o if isinstance(o, dict) else {"out": o[0] if isinstance(o, tuple) else o}
            outs.append({k: v.cpu() for k, v in o.items()})
        rows[name] = max(_rel_max(outs[0][k], outs[1][k]) for k in outs[1])
    log("heads_backbones_modules", card_vs_cpu_rel=rows, bar=HB_MODULE_REL_BAR,
        card=card_line())
    if max(rows.values()) > HB_MODULE_REL_BAR:
        raise AssertionError(f"modules card vs CPU: {rows}")


def heads_backbones_path(dev, rt, frames, box0) -> dict:
    """Phase 20: the CORNER and MLP heads on the main path, SPT on the
    RepVGG-A0 and Swin-T trunks, RepVGG's fused form, Alpha-Refine's
    training step, MobileNetV3 and the attentions. Returns the launches of
    each kernel counted in it."""
    from mmtrack_torch.eval.datasets import list_sequences

    t_phase = time.perf_counter()
    counted: dict = {}

    def add(counts):
        for k, n in counts.items():
            counted[k] = counted.get(k, 0) + n

    for head in HB_HEADS:
        add(head_path(dev, rt, frames, box0, head))
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "DepthTrack")
        ope_fixture(root, n_seqs=1, n_frames=ZOO_FRAMES)
        seq_dir = list_sequences(root, "DepthTrack")[0]
        for trunk in HB_TRUNKS:
            add(trunk_path(dev, seq_dir, trunk))
    repvgg_fuse_check(dev)
    add({"depthwise_xcorr": ar_train_check(dev)})
    modules_check(dev)
    log("heads_backbones_phase", seconds=time.perf_counter() - t_phase)
    return counted


# phase 21: the JAX package's serving opt-outs and its three measuring tools
TOOLS_FWD_B, TOOLS_FWD_T = 16, 8
TOOLS_LOOP_REPS = 1
TOOLS_TRAIN_B, TOOLS_TRAIN_STEPS = 32, 3
TOOLS_WIRE = dict(n_seq=4, n_frames=21, train_seqs=2, steps=200)
TOOLS_WIRES = ("host", "rgbindex")
# launches a forward (ab_kernels fwd) and a step (the loop's capture) by
# mode: `xla` is MMTRACK_ATTN and MMTRACK_MLP at xla, the crop run
# MMTRACK_CROP=gather (`pallas` is the fused loop's own crop)
TOOLS_FWD_LAUNCHES = {"fused": {"attn_block_fused": 9, "mlp_block_fused": 12},
                      "xla": {"attn_block_fused": 0, "mlp_block_fused": 0}}
TOOLS_LOOP_COUNTED = ("attn_block_fused", "mlp_block_fused", "crop_resize_normalized")
TOOLS_LOOP_LAUNCHES = {("fused", None): (9, 12, 1), ("xla", None): (0, 0, 1),
                       ("fused", "gather"): (9, 12, 0)}
# one forward without candidate elimination (12 blocks, all fusable) under
# each opt-out: (attn_block_fused, mlp_block_fused, flash_mhsa_qkv)
TOOLS_OPT_OUT_FORWARD = {"fused": ({}, (12, 12, 0)),
                         "xla": ({"attn": "xla", "mlp": "xla"}, (0, 0, 0)),
                         "mlp_xla": ({"mlp": "xla"}, (0, 0, 12))}


def opt_out_forwards(dev, rt, frames, box0) -> None:
    """Phase 3's check of the kernels against their plain versions, with
    the plain versions chosen through JAX's opt-outs: deep_rgbd (bf16,
    seed 0) built with the switches (utils/optouts.py::resolve) of each of
    TOOLS_OPT_OUT_FORWARD's choices, one
    forward without candidate elimination on the same crops, launches as
    listed; the maps within MAP_BAR / OFFSET_REL_BAR of the fused model's
    and the boxes, decoded at the xla run's score argmax, within MAP_BAR.
    The run with candidate elimination is printed."""
    cfg = vipt_experiment_config("deep_rgbd")
    mean, std = torch.from_numpy(MEAN_6CH).to(dev), torch.from_numpy(STD_6CH).to(dev)
    state = vipt_init_state(rt, frames[0], torch.from_numpy(box0))
    search, _ = crop_resize_normalized_plain(frames[1], state["box"], rt.search_factor,
                                             rt.search_size, mean, std)
    mask = generate_ctr_mask(rt.template_size // rt.stride, rt.ce_template_range, dev)
    counters = (attn_block_fused, mlp_block_fused, flash_mhsa_qkv)
    outs, launched = {}, {}
    for name, (env, _) in TOOLS_OPT_OUT_FORWARD.items():
        model = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0,
                               **optouts.resolve(**env).model_kwargs())
        with torch.inference_mode():
            before = profiling.counters()
            no_ce = model(state["template"], search, mask, None)
            launched[name] = tuple(profiling.launches(counters, before).values())
            outs[name] = {None: no_ce, "ce": model(state["template"], search, mask,
                                                   rt.ce_keep_lens)}
        del model
    want = {k: v[1] for k, v in TOOLS_OPT_OUT_FORWARD.items()}

    def vs(a, b):
        d = {k: (a[k].float() - b[k].float()).abs().max().item()
             for k in ("score_map", "size_map")}
        d["offset_map_rel"] = ((a["offset_map"].float() - b["offset_map"].float()).abs().max()
                               / b["offset_map"].float().abs().max()).item()
        at = cal_bbox(b["score_map"], a["size_map"], a["offset_map"])[0]
        d["boxes_at_plain_argmax"] = (at.float() - b["pred_boxes"].float()).abs().max().item()
        d["boxes"] = (a["pred_boxes"].float() - b["pred_boxes"].float()).abs().max().item()
        return d

    rows = {k: vs(outs["fused"][None], outs[k][None]) for k in ("xla", "mlp_xla")}
    with_ce = {k: vs(outs["fused"]["ce"], outs[k]["ce"]) for k in ("xla", "mlp_xla")}
    log("tools_opt_out_forward", launches=launched, expected=want, without_ce=rows, with_ce=with_ce,
        map_bar=MAP_BAR, offset_rel_bar=OFFSET_REL_BAR, card=card_line())
    bad = [k for k, d in rows.items() if d["score_map"] > MAP_BAR or d["size_map"] > MAP_BAR
           or d["offset_map_rel"] > OFFSET_REL_BAR or d["boxes_at_plain_argmax"] > MAP_BAR]
    if launched != want or bad:
        raise AssertionError(f"opt-out forwards: launches {launched} (want {want}), beyond the "
                             f"bars: {bad} {rows}")


def tools_path(dev, rt, frames, box0) -> dict:
    """Phase 21: the opt-outs and the three tools, in this process.
    Returns the kernel launches counted in it."""
    from mmtrack_torch.eval import wire_metric_ab
    from mmtrack_torch.kernels import ab_kernels
    from mmtrack_torch.train.bench_train import bench_train

    t_phase = time.perf_counter()
    reset_launches(*KERNEL_COUNTERS)
    opt_out_forwards(dev, rt, frames, box0)
    for mode, want in TOOLS_FWD_LAUNCHES.items():
        rec = ab_kernels.run_fwd(mode, TOOLS_FWD_B, TOOLS_FWD_T, dev)
        got = {k: rec["launches_per_forward"][k] for k in want}
        if got != want or not np.isfinite(rec["pred_boxes"]).all():
            raise AssertionError(f"ab_kernels fwd {mode}: launches {got} (want {want}), boxes "
                                 f"finite {np.isfinite(rec['pred_boxes']).all()}")
    loops = {}
    for (mode, crop), want in TOOLS_LOOP_LAUNCHES.items():
        rec = ab_kernels.run_loop(mode, TOOLS_LOOP_REPS, crop, dev)
        got = tuple(rec["launches_per_step"][k] for k in TOOLS_LOOP_COUNTED)
        loops[(mode, crop)] = rec["boxes"]
        if got != want or not boxes_inside(rec["boxes"]):
            raise AssertionError(f"ab_kernels loop {mode} crop={crop}: launches a step {got} "
                                 f"(want {want}), boxes inside {boxes_inside(rec['boxes'])}")
    ref = loops[("fused", None)]
    log("tools_loop_boxes", vs_fused_max_abs_px={f"{m}/crop={c}": float(np.abs(b - ref).max())
                                                 for (m, c), b in loops.items()})

    rows = bench_train(vipt_experiment_config("deep_rgbd"), (TOOLS_TRAIN_B,), TOOLS_TRAIN_STEPS,
                       dev)
    for row in rows:
        if (not (math.isfinite(row["loss_first"]) and math.isfinite(row["loss_last"]))
                or row["launches_per_step"] != DISK_PER_STEP):
            raise AssertionError(f"bench_train: {row} (launches a step want {DISK_PER_STEP})")

    model = build_viptrack(vipt_experiment_config("deep_rgbd"), dtype=torch.bfloat16,
                           param_dtype=torch.float32, device=dev, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        out = wire_metric_ab.run(model, tmp, device=dev, wires=TOOLS_WIRES, log_every=100,
                                 **TOOLS_WIRE)
        yuv420 = wire_metric_ab.yuv_unavailable(tmp) or "runs"
    losses = out["overfit"]["losses"]
    log("tools_wire_ab", wires=list(out["boxes"]), within_budget=out["within_budget"],
        deltas=out["deltas_vs_host"], decoder=out["decoder"],
        yuv420=yuv420, loss_first=losses[0],
        loss_last=losses[-1], samples=out["overfit"]["samples"],
        calibration_delta=out["overfit"]["delta"].tolist(), card=card_line())
    if not (out["within_budget"].get("rgbindex") and np.isfinite(losses).all()):
        raise AssertionError(f"wire A/B: rgbindex within budget {out['within_budget']}, "
                             f"losses finite {np.isfinite(losses).all()}")
    del model
    torch.cuda.empty_cache()
    log("tools_phase", seconds=time.perf_counter() - t_phase)
    return launch_counts(KERNEL_COUNTERS)


def timed(phase: str, fn, *args):
    """fn(*args), then a line with the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"{phase}_phase", seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    t_main = time.perf_counter()
    opted_out = optouts.set_names()
    if opted_out:
        raise SystemExit(f"chip_smoke.py holds every kernel to its path: unset "
                         f"{', '.join(opted_out)} (an opt-out would take a kernel off it)")
    dev = require_cuda()
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    lib = load_library()
    log_text = lib.path.with_suffix(".log").read_text() if lib.build_seconds else ""
    checks = gemm_build_checks(lib)
    log("build", seconds=time.perf_counter() - t0, nvcc_seconds=lib.build_seconds,
        library=str(lib.path.name), ptxas=[ln.strip() for ln in log_text.splitlines()
               if "registers" in ln or "spill" in ln], gemm=checks)
    if not checks["ok"]:
        raise AssertionError(f"GEMM kernels: no HGMMA/UTMALDG in the SASS or a spill: {checks}")

    gen = torch.Generator().manual_seed(0)
    t_kernels = time.perf_counter()
    with torch.inference_mode():
        attn_rows = compare_blocks("attn_block_fused", attn_block_fused,
                                   attn_block_fused_plain, 768, 3 * 768, 768,
                                   dict(num_heads=12, scale=64 ** -0.5), dev, gen)
        mlp_rows = compare_blocks("mlp_block_fused", mlp_block_fused, mlp_block_fused_plain,
                                  768, 4 * 768, 4 * 768, {}, dev, gen)
        zoo_rows = {
            "attn_block_fused": compare_blocks(
                "attn_block_fused", attn_block_fused, attn_block_fused_plain, 768, 3 * 768, 768,
                dict(num_heads=12, scale=64 ** -0.5), dev, gen, shapes=OO_SHAPES),
            "mlp_block_fused": compare_blocks(
                "mlp_block_fused", mlp_block_fused, mlp_block_fused_plain, 768, 4 * 768,
                4 * 768, {}, dev, gen, shapes=OO_SHAPES)}
        compare_mhsa(dev, gen, B)
        compare_gemms(dev, gen)
        compare_layernorm(dev, gen)
        crop_rows = compare_crops(dev, gen)
        prompt_rows = compare_prompt(dev, gen)
        log("kernels_phase", seconds=time.perf_counter() - t_kernels)
        xcorr_rows = timed("xcorr", compare_xcorr, dev, gen)

    cfg = vipt_experiment_config("deep_rgbd")
    rt = ViPTRuntime.from_config(cfg)
    frames, box0 = synthetic_frames(STEPS + 1, np.random.RandomState(0))
    frames = torch.from_numpy(frames).to(dev)
    model, tracker, launches = timed("main_path", main_path, cfg, rt, dev, frames, box0)
    timed("full_forward", full_forward, cfg, rt, dev, model, tracker, frames)
    for name, n in timed("scan", scan_path, rt, dev, model, frames, box0).items():
        launches[name] += n
    del model, tracker
    torch.cuda.empty_cache()

    t_train = time.perf_counter()
    with torch.inference_mode():
        mhsa_rows = compare_mhsa(dev, gen, TRAIN_B)
    time_functions(dev, gen)
    for name, n in train_path(cfg, dev).items():
        launches[name] = launches.get(name, 0) + n
    log("train_phase", seconds=time.perf_counter() - t_train)
    timed("train_check", train_kernels_vs_plain, cfg, dev)
    for phase, counts in (("vot", lambda: vot_path(dev)), ("ope", lambda: ope_path(dev, cfg, rt)),
                          ("zoo", lambda: zoo_path(dev)),
                          ("train_disk", lambda: train_disk_path(cfg, dev))):
        for name, n in timed(phase, counts).items():
            launches[name] = launches.get(name, 0) + n
    atom_dcf_path(dev)
    mdnet_path(dev)
    keeptrack_kys_path(dev)
    lwl_stm_path(dev)
    demo, entries = {}, {}
    try:
        zoo_train_path(dev, side=lambda: demo.update(start_learning_demo()))
        learning_demo_path(demo)
        entries.update(start_zoo_entries())
        host_launches = host_tools_path(dev, cfg, rt, frames, box0)
        zoo_entries_path(entries)
    finally:
        stop_zoo_entries(entries)
        if demo and demo["proc"].poll() is None:
            os.killpg(demo["proc"].pid, 9)
            demo["proc"].communicate()
    for counts in (host_launches, ddp_path(), heads_backbones_path(dev, rt, frames, box0),
                   tools_path(dev, rt, frames, box0)):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    log("phases", seconds=time.perf_counter() - t_main)

    zoo_rows["crop_resize_normalized"] = [r for r in crop_rows if r["zoo"]]

    def entry(name, source, replaces, rows):
        # the first row is the main path's shape: L=320 for the attention,
        # S=256 on 320x240 frames for the crop, Alpha-Refine's N=1 for xcorr;
        # the zoo's shapes (phase 10) follow as rows of their own
        first = rows[0]
        zoo = zoo_rows.get(name, [])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows + zoo),
                "ms": first["ms"], "plain_ms": first["plain_ms"],
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": first["library_ms"],
                **({"zoo_rows": [{k: r[k] for k in ("B", "L", "C", "S", "factor", "ms",
                                                    "device_ms",
                                                    "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms", "max_abs_err") if k in r}
                                 for r in zoo]}
                   if zoo else {})}

    search_row = next(r for r in crop_rows if r["H"] == FRAME_HW[0] and r["S"] == 256)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [
        entry("attn_block_fused", "mmtrack_torch/csrc/attention.cu",
              "mmtrack_tpu/ops/flash_attn.py:128", attn_rows),
        entry("mlp_block_fused", "mmtrack_torch/csrc/gemm.cu",
              "mmtrack_tpu/ops/mlp_fuse.py:74", mlp_rows),
        entry("crop_resize_normalized", "mmtrack_torch/csrc/crop.cu",
              "mmtrack_tpu/ops/pallas_preproc.py:21", [search_row] + crop_rows),
        entry("flash_mhsa_qkv", "mmtrack_torch/csrc/attention.cu",
              "mmtrack_tpu/ops/flash_attn.py:63", mhsa_rows),
        entry("depthwise_xcorr", "mmtrack_torch/csrc/xcorr.cu",
              "mmtrack_tpu/ops/xcorr.py:50", xcorr_rows),
        # no Pallas kernel there: JAX runs the prompt step as plain XLA
        {**entry("prompt_step", "mmtrack_torch/csrc/prompt.cu",
                 "mmtrack_tpu/models/vipt.py:215", prompt_rows),
         "rows": [{k: r[k] for k in ("L", "ms", "device_ms", "plain_ms", "plain_device_ms",
                                     "bound_ms", "token_row_ulps", "state_row_ulps")}
                  for r in prompt_rows]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
