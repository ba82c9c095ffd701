"""PyTorch/CUDA port of the multimodal social-media classification framework.

The JAX package ``socialmedia_textimage_classification_auxlosses_tpu`` beside
it is the reference; this package imports nothing from it. The sub-packages
mirror its layout, so each module here has a counterpart of the same path:

  core/      task registry, the training and serving configurations
  data/      tweet normalization, the hashing tokenizer, image ingest and the
             pixel cache, splits and batches
  models/    encoder towers, dual encoder, fusion heads, the flax weight carrier
  ops/       attention with hand-written Hopper kernels (csrc/), forward and
             backward, and plain versions
  utils/     logging, the serving parameter pre-cast
  train/     losses, ITM swap, AdamW, metrics, train/eval steps, the trainer,
             checkpoint save/load
  cli/       the late-fusion trainer (run_mm_late) and the serving endpoint

Entry points run on CUDA unless the caller asks for the CPU.
"""
