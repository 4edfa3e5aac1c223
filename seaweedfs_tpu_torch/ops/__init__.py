"""GF(2^8) arithmetic and the Reed-Solomon codecs: the plain PyTorch codec
(rs_torch) and the hand-written CUDA kernels behind it (rs_cuda): the byte
path and the plane-resident rebuild hop."""
