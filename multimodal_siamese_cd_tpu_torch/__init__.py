"""PyTorch/CUDA port of ``multimodal_siamese_cd_tpu``, for one NVIDIA H100.

A separate package beside the JAX one: it imports torch and numpy (and yaml
for configs), never jax, flax or the JAX package. It covers ``siameseunet``
and ``dtsiameseunet``:

* full-scene change inference — config, GeoTIFF I/O, scene cache, the
  no-augmentation dataset, the model, eval forward, metrics, the confusion-
  count CUDA kernel (``ops/csrc/confusion.cu``) and ``evaluation.
  inference_loop``;
* supervised training — losses, device augmentation, the training crop
  path and ``TrainLoader``, a train-mode BatchNorm with flax's semantics
  whose statistics come from the ``bn_stats`` CUDA kernel
  (``ops/csrc/bn_stats.cu``), the AdamW step, ``evaluation.
  model_evaluation``, checkpoints, ``trainers.run_training`` and the
  ``train_supervised`` CLI;
* dual-task training and assessment — ``DualTaskSiameseUNet``, the
  dual-task step, the ``train_supervised_dualtask`` CLI and
  ``evaluation.dualtask_quantitative_counts``, whose strict ``p > thr``
  counts come from the confusion kernel's strict variant;
* the 3x3 SAME convolution op ``ops.conv3x3`` (CUDA kernel
  ``ops/csrc/conv3x3.cu``), the counterpart of the JAX package's Pallas
  probe; no model calls it, in either package;
* serving — ``serving`` (``torch.export`` bundles, ``ServingModel``) and
  the ``export_serving`` CLI — and the single-device training knobs
  (``TRAINER.GRAD_ACCUM``, ``MODEL.REMAT``, ``TRAINER.PROFILE_DIR``,
  ``DATALOADER.WORKER_TYPE process``);
* data parallelism over processes — ``parallel`` (one process per card
  under ``torchrun`` with ``MSCD_DISTRIBUTED=1``; sync-BN through the
  ``bn_stats`` sums summed over the ranks, the loss over the global batch,
  one flat gradient all-reduce; evaluation groups sharded over the ranks,
  the confusion counts summed over them).

Entry points run on the card unless ``device="cpu"`` is passed.
"""
