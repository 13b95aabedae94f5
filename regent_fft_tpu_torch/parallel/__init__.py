"""Distributed transforms over ``torch.distributed`` (NCCL on the card,
gloo on the host).  Counterpart: ``regent_fft_tpu/parallel``."""
