"""Does Z12's finetune replay (``chip_smoke.finetune_replay``) depend on
what ran on the card before it?

One process on one card, from the repo root::

    python3 tools/z12_card_state_probe.py

It runs ``flash_attention`` at a rank's heads (``chip_smoke``'s
``SERVE_SHARDED_FLASH`` rows, which sat in phase Z2 when a full run once
read a gradient gap of 0.0251 against Z12's 0.02 bar), then Z11 and Z12's
training and finetune as ``chip_smoke.py`` runs them, and then the replay
again on the same weights in four card states:

* ``again``: as it stands, a second time;
* ``nan_filled``: every block the caching allocator keeps free filled with
  NaN first, so a kernel that reads memory no one wrote reads NaN;
* ``emptied``: after ``torch.cuda.empty_cache()``;
* ``deterministic``: with ``torch.backends.cudnn.deterministic`` on.

Each replay prints its loss and gradient gaps and the four largest leaf
gaps (each leaf's max gap over its max |CPU gradient|).  A run ends with
one JSON line of every replay.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_leaf_gap = c.leaf_gap
top_leaves = []


def paths(tree, path=()) -> list:
    """Each leaf's path in ``tree_leaves``' order, lists by index."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, path + (i,))]
    return [path]


def loud_gap(got, want):
    gaps = sorted((("/".join(map(str, path)),
                    float((a.cpu() - b.cpu()).abs().max()) / max(float(b.abs().max()), 1e-30))
                   for path, a, b in zip(paths(got), c.tree_leaves(got), c.tree_leaves(want))),
                  key=lambda r: -r[1])
    top_leaves.append(gaps[:4])
    return _leaf_gap(got, want)


def fill_free_with_nan() -> float:
    """Fill the device memory torch can take with NaN in 1 GiB blocks, then
    free them to the caching allocator; the GB filled."""
    blocks = []
    while True:
        try:
            blocks.append(torch.full((1 << 28,), float("nan"), device="cuda"))
        except torch.OutOfMemoryError:
            break
    torch.cuda.synchronize()
    filled = len(blocks) * 4 * (1 << 28) / 1e9
    del blocks
    return filled


def main() -> int:
    c.leaf_gap = loud_gap
    t0 = time.perf_counter()
    c._build.build(("flash_attention",))
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, *shape in c.SERVE_SHARDED_FLASH:
        row = c.check_flash(label, *shape, gen)
        print("flash_attention", label, row["max_abs_err"], flush=True)
    model = c.vgg16()
    params = model.init(seed=0, device="cuda")
    params_cpu = c.to_cpu(params)
    found = c.search(model, params, params_cpu)
    aes = {}
    for cut in dict.fromkeys((found["top_sc"], c.FINETUNE_CUT)):
        aes[cut], _ = c.train_at(model, params, params_cpu, cut)
    ae = aes[c.FINETUNE_CUT]
    out = {}
    top_leaves.clear()
    try:
        out["after_flash_rows"] = c.finetune_at(model, params, params_cpu, ae)["replay_rel_err"]
    except AssertionError as e:
        out["after_flash_rows"] = str(e)
    out["after_flash_rows_leaves"] = list(top_leaves)
    data = c.batches(c.FINETUNE_STEPS, c.AE_BATCH)
    small = [(x[:c.REPLAY_BATCH], y[:c.REPLAY_BATCH]) for x, y in data[:c.FINETUNE_REPLAY_STEPS]]

    def replay(name):
        top_leaves.clear()
        try:
            out[name] = c.finetune_replay(model, params, ae, small)
        except AssertionError as e:
            out[name] = str(e)
        out[f"{name}_leaves"] = list(top_leaves)
        print(name, json.dumps(out[name]), json.dumps(out[f"{name}_leaves"]), flush=True)

    replay("again")
    out["nan_gb"] = fill_free_with_nan()
    replay("nan_filled")
    torch.cuda.empty_cache()
    replay("emptied")
    torch.backends.cudnn.deterministic = True
    replay("deterministic")
    out["s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
