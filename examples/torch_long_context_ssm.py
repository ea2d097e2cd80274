"""Long-context decode with the attention-free SSM family, on the
PyTorch port (the counterpart of ``examples/long_context_ssm.py``).

Falcon-Mamba-style reduced model: prefill a prompt of 64, 256 and 1024
tokens, then decode 8 tokens with the O(1) per-token state; the serve
state's size does not depend on the context length, unlike a KV cache.
Prints the same arithmetic for the full falcon-mamba-7b at 500k
context. Runs on the GPU by default:

    PYTHONPATH=src python examples/torch_long_context_ssm.py
    PYTHONPATH=src python examples/torch_long_context_ssm.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import api


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    dev = resolve_device(ap.parse_args().device)
    cfg = get_config("falcon-mamba-7b").reduced()
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    B = 1
    sizes = set()
    for S in (64, 256, 1024):
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=dev)
        with torch.no_grad():
            last, state = api.prefill(cfg, params, tokens)
            ssm, conv = state
            state_bytes = sum(t.numel() * t.element_size() for t in state)
            # Decode 8 tokens: the state never grows.
            tok = last.argmax(-1)[:, None]
            for _ in range(8):
                logits, state = api.decode_step(cfg, params, tok, state)
                tok = logits.argmax(-1)[:, None]
        ssm2, conv2 = state
        assert ssm2.shape == ssm.shape and conv2.shape == conv.shape
        assert torch.isfinite(logits).all()
        sizes.add(state_bytes)
        print(f"context {S:5d}: serve state {state_bytes / 1e3:8.1f} kB "
              f"(constant in S)")
    assert len(sizes) == 1

    full = get_config("falcon-mamba-7b")
    ssm_bytes = (full.n_layers * full.d_inner * full.d_state * 4
                 + full.n_layers * (full.d_conv - 1) * full.d_inner * 2)
    # Equivalent full-attention KV at 500k (llama-7B-ish geometry).
    kv_bytes = 2 * 32 * 32 * 128 * 2 * 524288
    print(f"\nfull falcon-mamba-7b serve state: {ssm_bytes / 1e6:.1f} MB")
    print(f"full-attention KV at 500k context: {kv_bytes / 1e9:.1f} GB "
          f"({kv_bytes / ssm_bytes:,.0f}x larger)")
    print(f"device: {dev}")


if __name__ == "__main__":
    main()
