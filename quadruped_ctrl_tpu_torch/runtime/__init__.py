"""The native host runtime's binding: the reference's C ABI, computed by the
port's controller."""
