"""The port's search ops: encoding, the host oracles (WGL, JIT
linearization, the polynomial FIFO-queue checker), and the device WGL
search with its hand-written CUDA kernels."""
