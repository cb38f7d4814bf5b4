"""Attention ops of the port: each public function launches a CUDA kernel
(``csrc/``) on CUDA tensors and runs its plain PyTorch version on CPU
tensors. Import the modules (``ops.flash_attention``,
``ops.paged_attention``) directly."""
