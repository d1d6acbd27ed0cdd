"""How far the training path's gradients sit from a float64 reference on
the CPU, per parameter tensor: the kernel path on the card (the masked-GRU
kernel forward, plain backward), the plain path on the card (the encoder's
biGRU through the plain scans) and the plain path on the CPU in float32.
The policy is the biGRU-256 ActorCritic with random weights from a seed,
the batch random rows with env-like suffix neighbour masks, the losses
ppo.pi_loss_fn and ppo.v_loss_fn.

    python tests/torch_grad_precision.py [--batches 2048 16384]

Needs a CUDA card (float32 matmuls with TF32 off). Prints, per batch size
and loss, each tensor's largest float64 gradient and the three paths'
max |diff| divided by it. Not collected by pytest.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[2048, 16384])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rvo3d_tpu_torch.algo import ppo
    from rvo3d_tpu_torch.config import ModelConfig
    from rvo3d_tpu_torch.models import ActorCritic
    from rvo3d_tpu_torch.models import encoder as encoder_mod
    from rvo3d_tpu_torch.ops import masked_gru as mg

    cuda = torch.device("cuda")
    for b in args.batches:
        ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(3),
                         device=cuda)
        ac_cpu = ActorCritic(ModelConfig(), device="cpu")
        ac_cpu.load_state_dict(ac.state_dict())
        ac64 = ActorCritic(ModelConfig(), device="cpu")
        ac64.load_state_dict(ac.state_dict())
        ac64.double()
        g = torch.Generator().manual_seed(4)
        k = torch.randint(0, 11, (b, 1), generator=g)
        mask = torch.arange(10)[None, :] >= 10 - k
        nbr = torch.randn(b, 10, 9, generator=g) * mask[..., None]
        obs_self = torch.randn(b, 12, generator=g)
        with torch.no_grad():
            mu, std, v = ac_cpu(obs_self, nbr, mask)
            act = torch.round(mu + std * torch.randn(mu.shape, generator=g), decimals=2)
            logp = ac_cpu.logp(obs_self, nbr, mask, act)
        batch = ppo.AgentData(obs_self, nbr, mask, act, torch.randn(b, generator=g),
                              v + torch.randn(b, generator=g), logp, v)

        def grads(model, data):
            out = []
            for loss in (lambda: ppo.pi_loss_fn(model, data, 0.2)[0],
                         lambda: ppo.v_loss_fn(model, data)):
                model.zero_grad(set_to_none=True)
                loss().backward()
                out.append({n: p.grad.cpu().double() for n, p in model.named_parameters()
                            if p.grad is not None})
            return out

        card = ppo.AgentData(*[x.to(cuda) for x in batch])
        g_kernel = grads(ac, card)
        real = encoder_mod.masked_bigru_scan
        encoder_mod.masked_bigru_scan = mg.masked_bigru_scan_plain
        try:
            g_plain = grads(ac, card)
        finally:
            encoder_mod.masked_bigru_scan = real
        g_cpu = grads(ac_cpu, batch)
        g64 = grads(ac64, ppo.AgentData(*[x.double() if x.is_floating_point() else x
                                          for x in batch]))
        for li, loss in enumerate(("pi", "v")):
            print(f"B={b} loss={loss}: tensor, max|g64|, kernel/card, plain/card, "
                  "plain/CPU f32 (max |g - g64| / max |g64|)")
            for n, r in g64[li].items():
                scale = r.abs().max().item()
                errs = [(x[li][n] - r).abs().max().item() / scale
                        for x in (g_kernel, g_plain, g_cpu)]
                print(f"  {n:28s} {scale:.2e} " + " ".join(f"{e:.2e}" for e in errs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
