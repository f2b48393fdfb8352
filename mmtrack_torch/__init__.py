"""mmtrack_torch — the PyTorch + CUDA (Hopper) port of mmtrack_tpu.

The JAX package `mmtrack_tpu` stays the reference; each module here keeps
its counterpart's path and function names. Plain tensor code is PyTorch;
every Pallas kernel of the JAX package on the ported path is a CUDA C++
kernel in `csrc/`, built at first use by `kernels/build.py`.

Ported so far (ViPT batched tracking, ViPT prompt-tuning training, the
VOT entry with Alpha-Refine, the OPE entry with the streamed wire):
  ops/       crop (batched crop kernel), flash_attn, mlp_fuse (half-block
             kernels), xcorr (depthwise correlation kernel), compose
             (device compose of the streamed wire), ce, window, box,
             heatmap, losses, prroi, plain_grad
  models/    layers, heads (centre, corner), vipt, resnet, alpha_refine,
             convert (flax -> torch bridge)
  trackers/  vipt_tracker
  parallel/  batched_eval (composed frames, rgb + index and 4:2:0
             planes; one device or a rank's lanes), mesh (the
             data-parallel layer over torch.distributed), dryrun
  data/      synthetic data, sampler, processing, loader, composition,
             native_io (the C decoder of native/, cv2 fallback)
  train/     actor, optim, train_step, trainer, run (entry point)
  eval/      vot (TraX server, run_vot_exp), vot_entry (entry point),
             datasets, metrics, analysis, ope, batched_ope, run_ope
             (the OPE entry point), benchmark_suite, submission,
             transform_results
  utils/     device, logging, env (dataset roots), tb (tfevents writer),
             profiling (the tracer: spans, counters, graph captures;
             trace_profile, flops_estimate)
  registry   the 42 recipes
  native     the VOT polygon overlap over native/region.cc
  vis, vis_server, demo  debug images, the live dashboard, the demo entry

Kernel wrappers take the plain PyTorch version for a tensor on the CPU and
launch the kernel (or raise) for a tensor on CUDA. This package never
imports jax or flax.
"""

__version__ = "0.1.0"
