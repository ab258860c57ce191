"""The TPU probes' counterparts on the card (P1-P4).

Each probe holds hand-written kernels (dddpm_tpu_torch/csrc/probe_*.cu)
against their plain PyTorch versions on the card, then times every
variant at the TPU probe's default size:

    python -m dddpm_tpu_torch.probes.attention_ceiling   # P1, needs a card
    python -m dddpm_tpu_torch.probes.attention_writeback  # P2
    python -m dddpm_tpu_torch.probes.convres_variants     # P3
    python -m dddpm_tpu_torch.probes.cmajor_conv          # P4

On CPU tensors the wrappers take the plain versions (the tests use
them); `main()` needs a card and raises without one.  Three ablations
time a shipped kernel with parts of it compiled out (nothing checked):

    python -m dddpm_tpu_torch.probes.winograd_ablation      # K6
    python -m dddpm_tpu_torch.probes.convres_ablation       # K2, bf16
    python -m dddpm_tpu_torch.probes.convres_bwd_ablation   # K3, bf16
"""
