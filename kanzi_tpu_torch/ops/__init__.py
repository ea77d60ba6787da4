"""Device ops of the port: CUDA kernels (csrc/) behind wrappers that also
carry each kernel's plain PyTorch version for CPU tensors.

- ``block_stats``: order-0 histograms and the entropy gate
- ``huffman``:     Huffman lane pack and lane decode
- ``state``:       numpy state from the host runtime -> kernel tensors
"""
