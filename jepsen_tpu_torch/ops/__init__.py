"""The port's search ops: encoding, the host oracle, and the device
WGL search with its hand-written CUDA kernel."""
