#!/usr/bin/env python3
"""CLI decoder of the PyTorch port: tools/h264dec.py's options and output
on h264bsd_tpu_torch (see h264bsd_tpu_torch/cli.py), plus --device.

Usage:
  python tools/h264dec_torch.py [-o out.yuv] [-c golden.yuv] [-r]
      [--rgba out.rgba] [--render DIR] [--device DEV] stream.h264
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1]))

from h264bsd_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
