"""The benchmark's plain reference (``nerf.py``): torch alone, float32, TF32
off."""
