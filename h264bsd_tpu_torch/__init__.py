"""PyTorch/CUDA port of the h264bsd_tpu H.264 Baseline decoder.

The bitstream front-end is the same C++ library (its own copy under
frontend/csrc); the pixel stages run as PyTorch on the device with
hand-written CUDA kernels (csrc/*.cu): deblocking, intra reconstruction,
motion compensation and the residual transform, each frame replayed as
a CUDA graph per frame shape. Entry points: models.decoder.Decoder,
models.decoder.decode_stream and models.stream.StreamingDecoder; the
CLI (python -m h264bsd_tpu_torch.cli) and the entry hooks of
models/entry.py.
"""
