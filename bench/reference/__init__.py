"""Plain fp32 PyTorch references of the configurations' models: no
kernel, no CSR, no batching tricks, and nothing of the port."""
