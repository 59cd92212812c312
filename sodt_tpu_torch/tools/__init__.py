"""Command-line tools of the port (the JAX system's root `tools/`), run as
modules:

    python -m sodt_tpu_torch.tools.import_torch ref_best.pt --out best.npz
    python -m sodt_tpu_torch.tools.export_torch --weights best.npz \\
        --out ours_as_ref.pt --no-module
    python -m sodt_tpu_torch.tools.parity_check --pt ref_best.pt \\
        --data data.yaml --ref-map50 0.764
    python -m sodt_tpu_torch.tools.profile_eval --batch 4 --iters 2

Each takes --device (alias --platform), cuda by default: without a card it
raises unless given --device cpu.
"""
