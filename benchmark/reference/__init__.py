"""The plain reference of the benchmark: Matcha-TTS (text frontend, RoPE
encoder and durations, the CFM U-Net with its Euler steps), the plain
HiFi-GAN generator and the spectral-subtraction denoiser, in plain
PyTorch. A frozen copy of the plain modules of the system under test,
cut to inference: no hand-written kernel, no CUDA graph, no batching.
It imports nothing of the system under test and takes none of its
weights: ``benchmark.harness.weights`` draws them from the seed for both.
"""
