r"""Generic training loop with checkpoints and resume (port of
``robustcap_tpu/train/loop.py``).

Adam (or the optimizer a factory makes), gradient clipping by global norm,
validation every N iterations, best-checkpoint selection, early stopping,
ReduceLROnPlateau stepped per validation, a per-epoch hook, and resume of
weights, optimizer state and progress. Logging goes to stdout and a JSONL
metrics file.

Parameters are a tree (nested dicts and lists) of tensors, the layout of
``nn.rnn``. ``weights.pkl`` and ``best_weights.pkl`` are pickles of that
tree as numpy arrays, the JAX package's format, so each package reads the
other's; the optimizer state is the port's own (``optimizer_states.pt``).
A step reads nothing back from the device: its loss is summed there and
read at each validation.

With a ``mesh`` (``parallel.make_mesh``) training is data parallel: each
rank runs its rows of every batch (``parallel.make_dp_train_step``), the
gradients are summed across ranks before the clip, validation decides on
rank 0's value, and only rank 0 writes checkpoints.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Optional

import numpy as np
import torch

from ..convert import params_from_numpy
from ..device import resolve_device, tree_map
from ..parallel.mesh import Mesh, make_dp_train_step, replicate
from .data import SeqDataset, padded_batches

__all__ = ["train", "save_pytree", "load_pytree", "batch_inference",
           "save_checkpoint", "load_checkpoint", "NumpyTreeUnpickler"]


class NumpyTreeUnpickler(pickle.Unpickler):
    r"""Unpickles a tree of numpy arrays and nothing else."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            raise ValueError(
                "this pickle holds bfloat16 arrays, which need the ml_dtypes "
                "package; save the tree with float32 (or int8) arrays instead")
        if module.split(".")[0] == "numpy" or (module, name) in (
                ("builtins", "dict"), ("builtins", "list"),
                ("builtins", "tuple"), ("collections", "OrderedDict")):
            return super().find_class(module, name)
        raise ValueError(f"weights pickle: refusing to load {module}.{name}")


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise ValueError("numpy has no bfloat16: save a float32 (or "
                             "int8) tree")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(tree, path):
    r"""Pickle a tree of tensors (or arrays) as numpy arrays."""
    tree = tree_map(_to_numpy, tree)
    with open(path, "wb") as f:
        pickle.dump(tree, f)


def load_pytree(path, device="cuda"):
    r"""A pickled numpy tree (either package's ``save_pytree``) as tensors
    on ``device``; float32 and int8 leaves keep their kind."""
    with open(path, "rb") as f:
        tree = NumpyTreeUnpickler(f).load()
    return params_from_numpy(tree, device)


def save_checkpoint(tree, path):
    r"""``torch.save`` of a tree of tensors, moved to the CPU."""
    torch.save(tree_map(lambda t: t.detach().cpu(), tree), path)


def load_checkpoint(path, device="cuda"):
    r"""A :func:`save_checkpoint` file as tensors on ``device``."""
    return torch.load(path, map_location=resolve_device(device),
                      weights_only=True)


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree]


def _upload(a, dev):
    r"""A host array on ``dev``, copied without waiting for the device."""
    return None if a is None else torch.from_numpy(a).to(dev,
                                                         non_blocking=True)


def batch_inference(params, forward_fn, dataset, batch_size: int = 64,
                    device="cuda"):
    r"""A trained module over a dataset: per-sequence outputs as numpy
    arrays. ``params`` lie on ``device``."""
    dev = resolve_device(device)
    outs = []
    with torch.no_grad():
        for xs, _, lengths, init in padded_batches(dataset, batch_size,
                                                   shuffle=False):
            ys = forward_fn(params, _upload(xs, dev),
                            torch.from_numpy(lengths), _upload(init, dev),
                            None).cpu().numpy()
            outs += [ys[:L, b] for b, L in enumerate(lengths)]
    return outs


def _log_jsonl(path, record):
    if path is None:
        return
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _clip_by_global_norm(leaves, max_norm):
    r"""optax's ``clip_by_global_norm``: gradients kept below ``max_norm``,
    else scaled by ``max_norm / norm`` (no epsilon)."""
    grads = [p.grad for p in leaves if p.grad is not None]
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _state_fits(state, opt, leaves) -> bool:
    r"""True if a saved optimizer state has the structure of ``opt``'s, as
    the JAX loop compares optax trees: the same parameter groups over the
    same parameters with the same hyperparameter names (Adam's are not
    SGD's), and per-parameter tensors of their parameter's shape (or
    scalars, such as Adam's step)."""
    groups = state.get("param_groups", [])
    mine = opt.state_dict()["param_groups"]
    if len(groups) != len(mine) or any(
            g.get("params") != m["params"] or set(g) != set(m)
            for g, m in zip(groups, mine)):
        return False
    return all(int(i) < len(leaves) and all(
        not isinstance(v, torch.Tensor) or v.dim() == 0
        or v.shape == leaves[int(i)].shape for v in st.values())
        for i, st in state.get("state", {}).items())


def train(params, forward_fn: Callable, loss_fn: Callable,
          train_dataset: SeqDataset, valid_dataset: Optional[SeqDataset],
          save_dir: str, *, eval_fn: Optional[Callable] = None,
          optimizer: Optional[Callable] = None,
          learning_rate: float = 1e-3, num_epoch: int = 5000,
          batch_size: int = 256, valid_batch_size: int = 64,
          num_iter_between_vald: int = -1, early_stop_threshold: int = -1,
          clip_grad_norm: float = 0.0, load_last_states: bool = True,
          lr_scheduler_patience: Optional[int] = None,
          lr_scheduler_factor: float = 0.1, seed: int = 0,
          log_metrics: bool = True,
          epoch_hook: Optional[Callable] = None, device="cuda", mesh=None):
    r"""Train one RNN module on ``device``; returns the best parameters.

    ``forward_fn(params, xs, lengths, init, generator) -> ys`` (``generator``
    None at validation, where dropout is off) and ``loss_fn(ys, labels,
    lengths, count_lengths=None) -> scalar`` keep the loop generic over the
    per-RNN features and losses; ``xs``, ``labels`` and ``init`` arrive on
    ``device``, ``lengths`` on the host. A step passes ``count_lengths``,
    the lengths its denominators count (every loss of ``train.losses``
    takes it); validation calls ``eval_fn`` (default ``loss_fn``) without
    it. ``optimizer(params, lr) -> torch.optim.Optimizer`` makes the
    optimizer over the tree's tensors (default ``torch.optim.Adam``); the
    plateau scales its learning rate; a saved optimizer state resumes only
    into an optimizer of the same structure. Checkpoints in ``save_dir``:
    ``weights.pkl``, ``best_weights.pkl``, ``optimizer_states.pt``,
    ``train_info.json`` and ``metrics.jsonl``. Batches and augmentation
    draw from ``np.random.RandomState(seed)`` (the JAX package's batches);
    dropout from generators seeded from ``seed``, the device's default one
    (which ``nn.LSTM`` uses) forked so the caller's state is left as it
    was.

    ``mesh`` makes the step data parallel over its ranks on its device
    (``device`` is then unused): every rank draws the same global batches,
    runs its rows with the global batch's valid-frame counts, batches are
    whole (``drop_last``, and ``batch_size`` must divide the ranks), the
    parameters start from rank 0's, and dropout draws from generators
    seeded by ``(seed, rank)``. Validation runs on every rank
    and decides on rank 0's loss; rank 0 writes the checkpoints while the
    others wait, and every rank reads them on resume.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        # the default generators (nn.LSTM's dropout) and the explicit one
        # (dropout after linear1) start from different seeds: on the CPU
        # both are the same generator, which would draw equal masks
        drop_seed = seed if mesh is None else _rank_seed(seed, mesh.rank)
        torch.default_generator.manual_seed(drop_seed + 1)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                torch.cuda.manual_seed(drop_seed + 1)
        generator = torch.Generator(device=dev).manual_seed(drop_seed)
        return _train(
            params, forward_fn, loss_fn, train_dataset, valid_dataset,
            save_dir, dev=dev, generator=generator, eval_fn=eval_fn,
            optimizer=optimizer, learning_rate=learning_rate,
            num_epoch=num_epoch,
            batch_size=batch_size, valid_batch_size=valid_batch_size,
            num_iter_between_vald=num_iter_between_vald,
            early_stop_threshold=early_stop_threshold,
            clip_grad_norm=clip_grad_norm, load_last_states=load_last_states,
            lr_scheduler_patience=lr_scheduler_patience,
            lr_scheduler_factor=lr_scheduler_factor, seed=seed,
            log_metrics=log_metrics, epoch_hook=epoch_hook, mesh=mesh)


def _rank_seed(seed: int, rank: int) -> int:
    r"""Rank ``rank``'s dropout seed: ``seed`` itself on rank 0 (so one
    rank draws what the single-device loop draws), else one drawn from
    ``(seed, rank)``."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def _train(params, forward_fn, loss_fn, train_dataset, valid_dataset,
           save_dir, *, dev, generator, eval_fn, optimizer, learning_rate,
           num_epoch, batch_size, valid_batch_size, num_iter_between_vald,
           early_stop_threshold, clip_grad_norm, load_last_states,
           lr_scheduler_patience, lr_scheduler_factor, seed, log_metrics,
           epoch_hook, mesh):
    os.makedirs(save_dir, exist_ok=True)
    eval_fn = eval_fn or loss_fn
    lead = mesh is None or mesh.rank == 0
    log = print if lead else (lambda *args, **kw: None)
    metrics_path = (os.path.join(save_dir, "metrics.jsonl")
                    if log_metrics and lead else None)
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} must divide over the "
                             f"mesh's {mesh.size} ranks")
        params = replicate(params, mesh)
    params = tree_map(lambda t: t.detach().to(dev, torch.float32, copy=True)
                      .requires_grad_(), params)
    leaves = _tensor_leaves(params)
    opt = (optimizer or torch.optim.Adam)(leaves, learning_rate)
    lr_scale = 1.0
    train_info = {"epoch": 0, "it": 0, "total_it": 0, "min_vald_loss": 1e9,
                  "lr_scale": 1.0}

    w_file = os.path.join(save_dir, "weights.pkl")
    best_file = os.path.join(save_dir, "best_weights.pkl")
    opt_file = os.path.join(save_dir, "optimizer_states.pt")
    info_file = os.path.join(save_dir, "train_info.json")

    if load_last_states and os.path.exists(info_file):
        with open(info_file) as f:
            train_info = json.load(f)
        if os.path.exists(w_file):
            saved = _tensor_leaves(load_pytree(w_file, dev))
            if [t.shape for t in saved] != [t.shape for t in leaves]:
                raise ValueError(f"{w_file} does not fit these parameters")
            with torch.no_grad():
                for p, q in zip(leaves, saved):
                    p.copy_(q)
        lr_scale = train_info.get("lr_scale", 1.0)
        if os.path.exists(opt_file):
            state = torch.load(opt_file, map_location=dev, weights_only=True)
            if _state_fits(state, opt, leaves):
                opt.load_state_dict(state)
            else:
                log("optimizer config changed; reinitializing opt state")
        elif os.path.exists(os.path.join(save_dir, "optimizer_states.pkl")):
            log("optimizer_states.pkl holds the JAX package's optimizer "
                "state; reinitializing opt state")
        log("resumed: epoch %d it %d total_it %d" %
            (train_info["epoch"], train_info["it"], train_info["total_it"]))

    def set_lr():
        # ReduceLROnPlateau as JAX folds it in: an update scaled by
        # lr_scale is the update at learning_rate * lr_scale (for Adam and
        # SGD, whose updates are linear in the learning rate)
        for group in opt.param_groups:
            group["lr"] = learning_rate * lr_scale

    # one rank without a mesh: the same step on the whole batch
    step = make_dp_train_step(forward_fn, loss_fn, opt,
                              mesh or Mesh(None, 0, 1, dev),
                              clip_grad_norm=clip_grad_norm)

    def best_params():
        best = tree_map(lambda t: t.detach(), params)
        if lead and os.path.exists(best_file):
            best = load_pytree(best_file, dev)
        return best if mesh is None else replicate(best, mesh)

    vald_max_len = (max(len(d) for d in valid_dataset.data)
                    if valid_dataset is not None else 0)

    def run_validation():
        if valid_dataset is None:
            return None
        tot, nb = torch.zeros((), dtype=torch.float64, device=dev), 0
        with torch.no_grad():
            for xs, ys, lengths, init in padded_batches(
                    valid_dataset, valid_batch_size, shuffle=False,
                    pad_to=vald_max_len):
                lengths = torch.from_numpy(lengths)
                out = forward_fn(params, _upload(xs, dev), lengths,
                                 _upload(init, dev), None)
                tot += eval_fn(out, _upload(ys, dev), lengths).double()
                nb += 1
        return float(tot) / max(nb, 1)

    set_lr()
    rng_np = np.random.RandomState(seed)
    esn = early_stop_threshold if early_stop_threshold > 0 else float("inf")
    min_vald = train_info.get("min_vald_loss", 1e9)
    plateau_best = min_vald
    total_it = train_info["total_it"]
    plateau_count = 0

    for epoch in range(train_info["epoch"], num_epoch):
        if epoch_hook is not None:
            epoch_hook(epoch)
        train_loss = torch.zeros((), dtype=torch.float64, device=dev)
        n_step = 0
        batches = list(padded_batches(train_dataset, batch_size, rng_np,
                                      drop_last=mesh is not None))
        n_between = (num_iter_between_vald if num_iter_between_vald > 0
                     else len(batches))
        for i, (xs, ys, lengths, init) in enumerate(batches):
            if epoch == train_info["epoch"] and i < train_info["it"]:
                continue
            train_loss += step(params, xs, ys, lengths, init,
                               generator).double()
            n_step += 1
            total_it += 1

            if (i + 1) % n_between == 0 or i == len(batches) - 1:
                vald = run_validation()
                tl = float(train_loss) / max(n_step, 1)
                vl = vald if vald is not None else tl
                if mesh is not None:
                    # early stop and the plateau decide alike on every rank
                    tl, vl = mesh.broadcast_(torch.tensor(
                        [tl, vl], dtype=torch.float64, device=dev)).tolist()
                log("epoch %4d/%d  it %4d/%d  total %6d  "
                    "train %.6f  vald %.6f" %
                    (epoch, num_epoch, i + 1, len(batches), total_it, tl, vl))
                _log_jsonl(metrics_path,
                           {"epoch": epoch, "it": i + 1, "total_it": total_it,
                            "train_loss": tl, "vald_loss": vl})
                if lead:
                    save_pytree(params, w_file)
                    torch.save(opt.state_dict(), opt_file)
                    with open(info_file, "w") as f:
                        json.dump({"epoch": epoch, "it": i + 1,
                                   "total_it": total_it,
                                   "min_vald_loss": min_vald,
                                   "lr_scale": lr_scale}, f)
                improved = vl < min_vald
                if improved:
                    min_vald = vl
                    if lead:
                        save_pytree(params, best_file)
                if mesh is not None:
                    mesh.barrier()      # rank 0's files are written
                if improved:
                    esn = (early_stop_threshold if early_stop_threshold > 0
                           else float("inf"))
                else:
                    esn -= 1
                    if esn == 0:
                        log("early stop")
                        return best_params()
                # ReduceLROnPlateau stepped per validation: torch's relative
                # threshold 1e-4, patience counted in validations
                if lr_scheduler_patience is not None:
                    if vl < plateau_best * (1.0 - 1e-4):
                        plateau_best = vl
                        plateau_count = 0
                    else:
                        plateau_count += 1
                        if plateau_count > lr_scheduler_patience:
                            lr_scale *= lr_scheduler_factor
                            plateau_count = 0
                            set_lr()
                            log(f"plateau: lr scale -> {lr_scale}")
                train_loss = torch.zeros((), dtype=torch.float64, device=dev)
                n_step = 0
        train_info["it"] = 0
        train_info["epoch"] = epoch

    return best_params()
