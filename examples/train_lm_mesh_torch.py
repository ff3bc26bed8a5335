"""End-to-end example of the PyTorch port: train a reduced architecture LM
on a (4 data x 2 model) mesh with the DGS sparse gradient exchange, as
``examples/train_lm_mesh.py`` does on the reference's host mesh.

    PYTHONPATH=src python examples/train_lm_mesh_torch.py --arch mamba2-780m \
        --steps 100 --mode allgather            # on the card
    PYTHONPATH=src python examples/train_lm_mesh_torch.py --device cpu \
        --steps 20

The 8 mesh cells are lanes of one process (``LaneMesh(4, model=2)``): each
data worker's loss and gradients run through the sharded forward (tensor
and expert parallelism over the model axis), its exchange on each shard's
rows.  Markov token stream, 16 x 128 a step; the final parameters are
saved with ``repro_torch.checkpoint.save_checkpoint`` (an ``.npz`` the
reference's ``load_checkpoint`` reads too).
"""
import argparse
import os
import tempfile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mode", default="allgather",
                    choices=["dense", "allgather", "shardedps"])
    ap.add_argument("--density", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm.npz"))
    args = ap.parse_args()

    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import ExchangeConfig
    from repro_torch.data.synthetic import TokenStream, seeded_generator
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import init_params

    cfg = get_arch(args.arch).reduced()
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"), args.device)
    ex_cfg = ExchangeConfig(mode=args.mode, density=args.density,
                            momentum=0.9)
    step = build_train_step(cfg, mesh, ex_cfg, lr=args.lr, remat=False)
    params = init_params(cfg, seed=0, device=mesh.device)
    ex_state = step.init_state(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=128,
                         batch_size=16, seed=0, device=mesh.device)
    print(f"training {cfg.name} on mesh {mesh.shape} mode={args.mode} "
          f"density={args.density} device={mesh.device}")
    for i in range(args.steps):
        batch = stream.batch(i)
        if cfg.frontend_tokens:
            batch["frontend_embeds"] = torch.randn(
                (16, cfg.frontend_tokens, cfg.d_model),
                generator=seeded_generator(1, i)).to(mesh.device, cfg.cdtype)
        params, ex_state, loss = step(params, ex_state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"  step {i:4d} loss {float(loss):.4f}")
    save_checkpoint(args.checkpoint, params, step=args.steps,
                    extra={"arch": cfg.name, "mode": args.mode})
    print("saved", args.checkpoint)


if __name__ == "__main__":
    main()
