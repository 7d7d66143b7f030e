"""Decoders that take several streams at once (the JAX package's
h264bsd_tpu/parallel): parallel.multistream.MultiStreamDecoder decodes N
same-resolution streams on one card, one CUDA graph replay per round."""
