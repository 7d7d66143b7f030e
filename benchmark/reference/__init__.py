"""The benchmark's plain reference decoder (motion.py, h264.py)."""
