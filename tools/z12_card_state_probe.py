"""Where does Z12's finetune-replay gradient gap (``chip_smoke.finetune_replay``)
come from?

One process on one card, from the repo root::

    python3 tools/z12_card_state_probe.py [--repeats N]

It trains Z12's AE at ``FINETUNE_CUT`` as ``chip_smoke.py`` does, then runs
the replay's steps ``--repeats`` times with cuDNN's default algorithms and
as many times with ``torch.backends.cudnn.deterministic`` on, and then
``chip_smoke.finetune_replay`` itself as many times.  At each step it prints:

* digests of the card's state, loss and gradient, so that a run which
  differs from the others in its bits shows;
* the gap of the card's gradient to the CPU's of the same state and batch,
  each leaf's largest gap over its max |CPU gradient| (the four largest);
* the branch (``chip_smoke.branch_moves``, in all and by layer): where the
  card and the CPU send a ReLU input to different sides of 0 (``flips``) or
  a 2x2 pool to a different element (``moves``), and the largest distance
  of the card's choice from the CPU's over the layer's max |input|;
* ``gap_on_card_branch``: the same gap with the CPU's gradient taken on the
  card's branch (``chip_smoke.branch_loss``: each ReLU multiplies by the
  card's mask, each pool takes the card's element), as Z12 now holds it.

A run ends with one JSON line of every step.  ``--small`` runs the same
code with the CPU on both sides on the CIFAR-sized VGG (a dry run of the
script, not a measurement).
"""
import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.core import bottleneck as B  # noqa: E402
from repro_torch.models.vgg import vgg_cifar  # noqa: E402
from repro_torch.training.optimizer import adam_init, adam_update  # noqa: E402


def paths(tree, path=()) -> list:
    """Each leaf's path in ``tree_leaves``' order, lists by index."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, path + (i,))]
    return [path]


def digest(tree) -> str:
    h = hashlib.sha1()
    for t in c.tree_leaves(tree):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:12]


def leaf_gaps(got, want) -> list:
    """(path, gap over the leaf's max, flat index of the largest gap), the
    four largest."""
    rows = []
    for path, a, b in zip(paths(want), c.tree_leaves(got), c.tree_leaves(want)):
        d = (a.detach().cpu() - b).abs().flatten()
        rows.append(("/".join(map(str, path)),
                     float(d.max()) / max(float(b.abs().max()), 1e-30), int(d.argmax())))
    return sorted(rows, key=lambda r: -r[1])[:4]


def by_layer(card, cpu) -> list:
    """``chip_smoke.branch_moves`` of each ReLU and pool where the card's
    branch leaves the CPU's, with the layer's place in the record."""
    rows = [{"at": i, **c.branch_moves([a], [b])} for i, (a, b) in enumerate(zip(card, cpu))]
    return [r for r in rows if r["flips"] or r["moves"]]


def data_small(data) -> list:
    return [(x[:c.REPLAY_BATCH], y[:c.REPLAY_BATCH]) for x, y in data]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    dev = "cpu" if args.small else "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if args.small:
        model, cut, hw = vgg_cifar(), 5, 32
        params = model.init(seed=0, device=dev)
        data = [next(c.toy_image_iter(c.REPLAY_BATCH, hw=hw, seed=s))
                for s in range(c.FINETUNE_REPLAY_STEPS)]
        feat = tuple(model.activation_shapes(params, 1)[cut][1:])
        ae = B.init_bottleneck(c.AE_SEED, feat, c.AE_RATE, device=dev)
    else:
        model, cut = c.vgg16(), c.FINETUNE_CUT
        params = model.init(seed=0, device=dev)
        ae, _ = c.train_at(model, params, c.to_cpu(params), cut)
        data = c.batches(c.FINETUNE_STEPS, c.AE_BATCH)[:c.FINETUNE_REPLAY_STEPS]
    small = [(torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y))
             for x, y in data_small(data)]
    cpu_at = {}
    rows = []
    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        for r in range(args.repeats):
            pad = torch.empty((r * 37 << 18,), device=dev)   # another allocator state
            state = {"params": params, "ae": ae}
            opt = adam_init(state)
            for step, (x, y) in enumerate(small):
                xd, yd = x.to(dev), y.to(dev)
                loss, g = B.value_and_grad(
                    lambda st: B.task_loss(model, st["params"], st["ae"], cut, xd, yd), state)
                key = digest(state)
                if key not in cpu_at:
                    st_cpu = c.to_cpu(state)
                    card_branch, cpu_branch = [], []
                    with torch.no_grad():
                        card_loss = c.branch_loss(model, state, cut, xd, yd, record=card_branch)
                    l_cpu, g_cpu = B.value_and_grad(
                        lambda st: c.branch_loss(model, st, cut, x, y, record=cpu_branch), st_cpu)
                    _, g_on_card = B.value_and_grad(
                        lambda st: c.branch_loss(model, st, cut, x, y, branch=card_branch),
                        st_cpu)
                    cpu_at[key] = {"loss": float(l_cpu), "g": g_cpu, "g_on_card": g_on_card,
                                   "branch": c.branch_moves(card_branch, cpu_branch),
                                   "by_layer": by_layer(card_branch, cpu_branch),
                                   "forward_repeats": bool(float(card_loss) == float(loss))}
                    del card_branch, cpu_branch
                ref = cpu_at[key]
                row = {"mode": mode, "repeat": r, "step": step, "state": key,
                       "loss_hex": float(loss).hex(), "grad": digest(g),
                       "loss_gap": abs(float(loss) - ref["loss"]) / abs(ref["loss"]),
                       "gap": leaf_gaps(g, ref["g"]),
                       "gap_on_card_branch": leaf_gaps(g, ref["g_on_card"]),
                       "forward_repeats": ref["forward_repeats"], "branch": ref["branch"],
                       "by_layer": ref["by_layer"]}
                rows.append(row)
                print(json.dumps(row), flush=True)
                state, opt = adam_update(state, g, opt, c.AE_LR)
            del pad
    held = []
    if not args.small:      # Z12's own check, as chip_smoke.py runs it
        torch.backends.cudnn.deterministic = False
        for _ in range(args.repeats):
            try:
                held.append(c.finetune_replay(model, params, ae, data_small(data)))
            except AssertionError as e:
                held.append(str(e))
            print("finetune_replay", json.dumps(held[-1]), flush=True)
    print(json.dumps({"s": time.perf_counter() - t0, "states": len(cpu_at), "held": held,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
