"""State trees, rotations, interpolation and matmul precision."""
