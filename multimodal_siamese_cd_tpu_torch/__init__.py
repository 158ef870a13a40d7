"""PyTorch/CUDA port of ``multimodal_siamese_cd_tpu``, for one NVIDIA H100.

A separate package beside the JAX one: it imports torch and numpy (and yaml
for configs), never jax, flax or the JAX package. It covers ``siameseunet``:

* full-scene change inference — config, GeoTIFF I/O, scene cache, the
  no-augmentation dataset, the model, eval forward, metrics, the confusion-
  count CUDA kernel (``ops/csrc/confusion.cu``) and ``evaluation.
  inference_loop``;
* supervised training — losses, device augmentation, the training crop
  path and ``TrainLoader``, a train-mode BatchNorm with flax's semantics
  whose statistics come from the ``bn_stats`` CUDA kernel
  (``ops/csrc/bn_stats.cu``), the AdamW step, ``evaluation.
  model_evaluation``, checkpoints, ``trainers.run_training`` and the
  ``train_supervised`` CLI.

Entry points run on the card unless ``device="cpu"`` is passed.
"""
