"""The port's search ops: encoding, the host oracles (WGL, JIT
linearization, the polynomial FIFO-queue checker), the device WGL
search with its hand-written CUDA kernels, the Elle cycle-engine route
and the kernels' build and binding (`_native`)."""
