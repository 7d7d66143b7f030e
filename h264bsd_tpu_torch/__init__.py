"""PyTorch/CUDA port of the h264bsd_tpu H.264 Baseline decoder.

The bitstream front-end is the same C++ library (its own copy under
frontend/csrc); the pixel stages run as PyTorch on the device with
hand-written CUDA kernels (csrc/*.cu) for the order-dependent passes:
intra reconstruction and in-loop deblocking. Entry points:
models.decoder.Decoder and models.decoder.decode_stream.
"""
