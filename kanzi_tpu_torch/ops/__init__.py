"""Device ops of the port: CUDA kernels (csrc/) behind wrappers that also
carry each kernel's plain PyTorch version for CPU tensors.

- ``block_stats``: order-0 histograms and the entropy gate (K1, K2)
- ``huffman``:     Huffman lane pack and lane decode (K3, K4)
- ``ans``:         4-state rANS chunk encode and decode (K5, K6)
- ``range``:       range coder chunk encode and decode (K7, K8)
- ``suffix_sort``: suffix array by prefix doubling and the BWT payload (K9)
- ``bwt_inverse``: BWT inverse by a batched LF walk (K10)
- ``fpaq_batch``:  batched FPAQ encode (K11)
- ``state``:       numpy state from the host runtime -> kernel tensors
"""
