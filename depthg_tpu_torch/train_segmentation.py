"""Train the DepthG segmenter with the PyTorch port.

Usage (the CLI surface of ``scripts/train_segmentation.py``)::

    python -m depthg_tpu_torch.train_segmentation [key=value | --key value] ...

Reads ``depthg_tpu_torch/configs/local_config.yml`` with overrides and
trains on ``device`` (default ``cuda``; it raises when there is no card,
and only ``device=cpu`` runs on the CPU): contrastive correlation
distillation with depth guidance, three Adam groups, the decay schedules as
host functions of the step, validation every ``val_freq`` steps with
Hungarian-matched metrics, ``best`` / ``last`` / top-k checkpoints monitored
on ``test/cluster/mIoU`` (Accuracy for potsdam).

``arch`` is ``dino``, ``dino_depth`` (the depth-fused featurizer, with
``guidance``) or ``feature-pyramid`` (``granularity``, ``continuous``), and
``lhp=True`` adds the LHP loss (``propagation_strategy``, ``lhp_weight``,
...). The frozen DINO backbone comes from ``pretrained_weights`` (a DINO
``.pth`` or a Lightning ``.ckpt``); the pyramid's ResNet-50 from
``load_model(model_type, {output_root}/data)``. Without a file the backbone
is randomly initialized from the seed, with a warning. Batches are staged through pinned host memory two
ahead of the step. Scalars go to a jsonl log, and to TensorBoard and wandb
when those are installed and asked for.

Each checkpoint ``<tag>`` is ``<tag>.pt`` (``utils.ckpt.save_segmenter``:
the eval state dict with the frozen backbone, the run config and the
metrics; the eval, demo and serve entry points read it for every arch, as
the JAX trainer's orbax directory), ``<tag>.train_state.pt``, the port's
own resumable train state for ``resume=`` (``utils.ckpt.save_train_state``),
and for ``arch=dino`` also ``<tag>.ckpt``, a reference-compatible Lightning
checkpoint that the eval CLIs of both packages read (the JAX trainer
exports that layout for ``arch=dino`` only too). Differences from the JAX
trainer: no orbax directory and no pickled optax state are written, and a
pickled optax state cannot be resumed (unpickling it needs JAX); the
random draws of step k are seeded from (seed, k) and ``resume=`` also
repositions the data loader, so a resumed run repeats an uninterrupted
one. ``backbone_dtype`` takes float32, bfloat16 (the default) and int8.

Data-parallel over N GPUs, one process each::

    torchrun --nproc_per_node N -m depthg_tpu_torch.train_segmentation n_devices=N ...

``n_devices`` is the world size (empty: the group's, 1 without torchrun)
and ``batch_size`` the global batch, which must divide by it. Every rank
builds the same seeded loader and loads only its rows of each batch
(items are seeded by seed, epoch and index, so they are the rows the JAX
host feeds its mesh from the global batch), so the run is the
single-process run (``train.step``); validation is sharded with its
confusion blocks all-reduced; only rank 0 writes the logs and the
checkpoints; ``resume=`` loads on every rank. NCCL joins the ranks on CUDA,
gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from datetime import datetime
from os.path import join

import numpy as np
import torch

from depthg_tpu_torch.config import cli_overrides, load_config
from depthg_tpu_torch.data import ContrastiveSegDataset, DataLoader, get_transform
from depthg_tpu_torch.data.loader import device_prefetch
from depthg_tpu_torch.data.transforms import GeometricAug, PhotometricAug
from depthg_tpu_torch.inference import Segmenter, fcfg_from_run_cfg, make_validation_step
from depthg_tpu_torch.models.pyramid import RESNET50_MODEL_TYPES, load_model
from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.runtime import get_device
from depthg_tpu_torch.train import decay as decay_lib
from depthg_tpu_torch.train import losses as loss_lib
from depthg_tpu_torch.train import step as step_lib
from depthg_tpu_torch.utils import ckpt as ckpt_lib
from depthg_tpu_torch.utils.metrics import SegMetrics

STEP_SEED_STRIDE = 1_000_003  # the draws of step k are seeded seed * stride + k


def validation_res(cfg) -> int:
    """The reference's fixed validation size (224 for MAE, else 320), for a
    ViT at the nearest multiple of its patch size: 322 for DINOv2's 14."""
    res = 224 if cfg.model_type == "mae" else 320
    if cfg.get("arch") == "feature-pyramid":
        return res
    patch = int(cfg.get("dino_patch_size", 8))
    return round(res / patch) * patch


def build_datasets(cfg):
    eval_res = validation_res(cfg)
    use_augs = float(cfg.aug_alignment_weight) > 0
    data_dir = cfg.data_dir
    train_dataset = ContrastiveSegDataset(
        data_dir=data_dir, dataset_name=cfg.dataset_name, crop_type=cfg.crop_type,
        image_set="train",
        transform=get_transform(cfg.res, False, cfg.loader_crop_type),
        target_transform=get_transform(cfg.res, True, cfg.loader_crop_type),
        cfg=cfg,
        aug_geometric_transform=GeometricAug(cfg.res) if use_augs else None,
        aug_photometric_transform=PhotometricAug() if use_augs else None,
        num_neighbors=cfg.num_neighbors, mask=True, pos_images=True, pos_labels=True,
        return_depth=cfg.use_depth, depth_type=cfg.depth_type)

    val_crop = None if cfg.dataset_name == "voc" else "center"
    val_dir = join(data_dir, "nyuv2") if cfg.dataset_name == "nyuv2" else data_dir
    val_dataset = ContrastiveSegDataset(
        data_dir=val_dir, dataset_name=cfg.dataset_name, crop_type=None,
        image_set="val",
        transform=get_transform(eval_res, False, val_crop),
        target_transform=get_transform(eval_res, True, val_crop),
        cfg=cfg, mask=True)
    return train_dataset, val_dataset, eval_res


def load_backbone(cfg, model: Segmenter) -> str:
    """Load the frozen backbone of ``model``, strictly: the ViT from
    ``cfg.pretrained_weights`` (a DINO ``.pth`` or a Lightning ``.ckpt``);
    for ``arch=feature-pyramid`` the ResNet-50 of ``load_model(model_type,
    {output_root}/data)``. Without a file the random init of the seed stays,
    with a warning. Returns what was used."""
    if cfg.arch == "feature-pyramid":
        # the model_type is checked before the filesystem is touched, so a
        # missing file can never swap model families: the random fallback
        # is a ResNet-50 (FeaturePyramidNet's channel layout)
        if cfg.model_type not in RESNET50_MODEL_TYPES:
            raise ValueError(
                f"arch=feature-pyramid needs a resnet50-family model_type "
                f"{sorted(RESNET50_MODEL_TYPES)} (FeaturePyramidNet channel "
                f"layout, src/modules.py:703); got {cfg.model_type!r}")
        try:
            net, _ = load_model(cfg.model_type, join(cfg.output_root, "data"))
        except FileNotFoundError as e:
            print(f"WARNING: {e}; the backbone is randomly initialized.")
            return "random"
        model.net.model.load_state_dict(net.state_dict(), strict=True)
        return cfg.model_type
    path = cfg.get("pretrained_weights")
    if path and os.path.exists(path):
        if path.endswith(".ckpt"):
            sd, _ = ckpt_lib.load_lightning_ckpt(path)
            vit_sd = {k[len("net.model."):]: v for k, v in sd.items()
                      if k.startswith("net.model.")}
        else:
            vit_sd = ckpt_lib.load_dino_pth(path)
        model.net.model.load_state_dict(vit_sd, strict=True)
        return path
    print("WARNING: pretrained_weights not provided/found. The reference would "
          "download DINO weights from torch hub; nothing is downloaded here, "
          "so the backbone is randomly initialized. Pass "
          "pretrained_weights=/path/to/dino.pth for real runs.")
    return "random"


def _stage_fn(needed, device: torch.device):
    """Host batch (this rank's rows of the global batch, as the loaders
    give them) -> dict of device tensors through pinned memory."""
    def stage(batch: dict) -> dict:
        out = {}
        for k in needed:
            if k not in batch:
                continue
            v = np.asarray(batch[k])
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return out
    return stage


def main(argv=None) -> dict:
    overrides = cli_overrides(argv if argv is not None else sys.argv[1:])
    cfg = load_config("local_config.yml", overrides)

    if cfg.arch not in ("dino", "dino_depth", "feature-pyramid"):
        raise NotImplementedError(f"arch={cfg.arch}")
    if cfg.arch == "feature-pyramid" and float(cfg.get("rec_weight", 0)) > 0:
        # broken in the reference too: its decoder maps dim -> n_feats where
        # FeaturePyramidNet.n_feats = dim (src/modules.py:709), but the rec
        # loss dots rec_feats against the 2048-channel 7x7 low_res_feats
        # (src/train_segmentation.py:392-397) — shape mismatch either way.
        # Every shipped config keeps rec_weight=0 for this arch.
        raise NotImplementedError(
            "rec_weight > 0 is unsupported for arch=feature-pyramid (the "
            "reference's own decoder/feats shapes disagree there)")
    if str(cfg.get("resume") or "").endswith(".pkl"):
        raise NotImplementedError(
            f"resume={cfg.resume}: the JAX trainer's pickled optax state needs JAX "
            "to unpickle; resume from the port's <tag>.train_state.pt")
    fcfg = fcfg_from_run_cfg(cfg)
    step_lib.check_supported(step_lib.hparams_from_cfg(cfg, 0))
    device = get_device(cfg.get("device", "cuda"))
    dist.init_from_env(device=device.type)
    world = dist.check_world(cfg.get("n_devices"))
    if int(cfg.batch_size) % world:
        raise ValueError(f"batch_size={cfg.batch_size} does not divide over "
                         f"{world} devices")
    device = dist.rank_device(device)

    if cfg.get("image_cache_mb") is None:
        # training revisits every image each epoch: decoded-image LRU on
        from depthg_tpu_torch.data.datasets import IMAGE_CACHE
        IMAGE_CACHE.configure(512)

    seed = int(cfg.get("seed", 0))
    np.random.seed(seed)

    stamp = [datetime.now().strftime("%b%d_%H-%M-%S")]
    if dist.active():  # one run name for every rank
        torch.distributed.broadcast_object_list(stamp, src=0)
    name = "{}/{}_{}_date_{}".format(cfg.log_dir, cfg.dataset_name, cfg.experiment_name,
                                     stamp[0])
    checkpoint_dir = join(cfg.output_root, "checkpoints", name.replace("/", "_"))
    log_path = join(cfg.output_root, "logs", name.replace("/", "_") + ".jsonl")
    if not dist.is_main():  # only rank 0 writes
        return _run(cfg, device, fcfg, name, checkpoint_dir, log_path, None)
    os.makedirs(checkpoint_dir, exist_ok=True)
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "a") as log_file:
        return _run(cfg, device, fcfg, name, checkpoint_dir, log_path, log_file)


def _run(cfg, device, fcfg, name, checkpoint_dir, log_path, log_file) -> dict:
    seed = int(cfg.get("seed", 0))
    main_rank = log_file is not None
    wandb = None
    if main_rank and cfg.get("wandb_logging"):
        try:
            import wandb as _wandb

            _wandb.init(project="depthg-torch", name=name, config=dict(cfg),
                        sync_tensorboard=True)
            wandb = _wandb
        except ImportError:
            print("wandb_logging=True but wandb is not installed; jsonl logs only")

    tb_writer = None
    tb_dir = join(cfg.output_root, "tb", name.replace("/", "_"))
    if main_rank and cfg.get("tensorboard_logging", True):
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(log_dir=tb_dir)
        except ImportError:
            print("tensorboard not available; jsonl logs only")
    # histograms only where rank 0 has a writer; every rank must agree, as
    # the histograms are gathered
    hist_on = [tb_writer is not None]
    if dist.active():
        torch.distributed.broadcast_object_list(hist_on, src=0)

    train_dataset, val_dataset, eval_res = build_datasets(cfg)
    n_classes = train_dataset.n_classes

    hp = step_lib.hparams_from_cfg(cfg, n_classes)
    dcfg = decay_lib.from_cfg(cfg)
    base_lcfg = loss_lib.from_cfg(cfg)

    init_gen = torch.Generator().manual_seed(seed)  # the weights, then the LHP head
    model = Segmenter(fcfg, n_classes, n_classes + hp.extra_clusters,
                      decoder=True).init_weights(init_gen)
    backbone = load_backbone(cfg, model)
    state = step_lib.state_from_model(model.to(device), hp, init_gen)

    train_loader = DataLoader(train_dataset, cfg.batch_size, shuffle=True,
                              num_workers=cfg.num_workers, drop_last=True, seed=seed)
    val_loader = DataLoader(val_dataset, cfg.batch_size, shuffle=False,
                            num_workers=cfg.num_workers)

    if cfg.get("resume"):
        ckpt_lib.load_train_state(cfg.resume, state)
        train_loader.seek(state.step)
        print(f"resumed from {cfg.resume} at step {state.step}")

    val_step = make_validation_step(n_classes, hp.extra_clusters,
                                    group=torch.distributed.group.WORLD if dist.active() else None)
    gen = torch.Generator(device=device)

    monitor = "test/cluster/Accuracy" if cfg.dataset_name == "potsdam" else "test/cluster/mIoU"
    best_monitor = -1.0
    maxima: dict = {}

    needed = {"img", "img_pos", "label", "depth", "depth_pos"}
    if cfg.use_true_labels:
        needed.add("label_pos")
    if cfg.use_salience:
        needed |= {"mask", "mask_pos"}
    if float(cfg.aug_alignment_weight) > 0:
        needed |= {"img_aug", "coord_aug"}
    stage = _stage_fn(sorted(needed), device)

    def save_ckpt(tag, metrics=None):
        if not main_rank:
            return
        ckpt_lib.save_segmenter(join(checkpoint_dir, tag + ".pt"),
                                ckpt_lib.eval_state_dict(step_lib.eval_state_dict(state)),
                                cfg=dict(cfg), metrics=metrics, step=state.step)
        if cfg.get("export_torch_ckpt", True) and cfg.arch == "dino":
            ckpt_lib.export_lightning_ckpt(
                join(checkpoint_dir, tag + ".ckpt"), step_lib.eval_state_dict(state),
                cfg=dict(cfg), n_classes=n_classes, global_step=state.step)
        ckpt_lib.save_train_state(join(checkpoint_dir, tag + ".train_state.pt"), state)

    # save_top_k retention: the best step-tagged checkpoints by the monitor,
    # beside best and last
    topk_kept: list = []  # [(monitor value, step, tag)]

    def save_topk(value, metrics):
        tag = f"step{state.step}"
        save_ckpt(tag, metrics)
        topk_kept.append((value, state.step, tag))
        topk_kept.sort(key=lambda t: (-t[0], -t[1]))
        while main_rank and len(topk_kept) > int(cfg.get("save_top_k", 2)):
            _, _, old = topk_kept.pop()
            for suffix in (".pt", ".ckpt", ".train_state.pt"):
                p = join(checkpoint_dir, old + suffix)
                if os.path.exists(p):
                    os.remove(p)

    def run_validation():
        linear_m = SegMetrics("test/linear/", n_classes, 0, False)
        cluster_m = SegMetrics("test/cluster/", n_classes, hp.extra_clusters, True)
        val_stage = _stage_fn(("img", "label"), device)
        for batch in val_loader:
            b = val_stage(batch)
            ls, cs = val_step(state.model, b["img"], b["label"], eval_res)
            linear_m.add_stats(ls)
            cluster_m.add_stats(cs)
        tb = {**linear_m.compute(), **cluster_m.compute()}
        for k, v in tb.items():
            mk = k.replace("test/", "test/Max", 1)
            if v > maxima.get(mk, -1):
                maxima[mk] = v
        tb.update(maxima)
        tb["step"] = state.step
        if not main_rank:
            return tb
        print(json.dumps(tb))
        log_file.write(json.dumps(tb) + "\n")
        log_file.flush()
        if wandb is not None:
            wandb.log(tb, step=state.step)
        if tb_writer is not None:
            for k, v in tb.items():
                tb_writer.add_scalar(k, v, state.step)
        return tb

    if tb_writer is not None:
        hparams = {k: v for k, v in cfg.items() if isinstance(v, (bool, int, float, str))}
        tb_writer.add_hparams(hparams, {monitor: 0.0}, run_name=".")

    print(f"training {cfg.dataset_name} for {cfg.max_steps} steps (n_classes={n_classes}, "
          f"device={device}, backbone={backbone})")
    t_last = time.time()
    pending_logs = None
    logs = None
    while state.step < cfg.max_steps:
        for batch in device_prefetch(iter(train_loader), stage,
                                     depth=int(cfg.get("device_prefetch", 2))):
            if state.step >= cfg.max_steps:
                break
            step_num = state.step
            mode, s = decay_lib.sampling_schedule(dcfg, step_num)
            w = decay_lib.depth_feat_weight(dcfg, step_num)
            sh = decay_lib.depth_feat_shift(dcfg, step_num)
            gen.manual_seed(seed * STEP_SEED_STRIDE + step_num)
            hist_freq = cfg.get("hist_freq")
            want_hist = bool(hist_on[0] and hist_freq and step_num > 0
                             and step_num % int(hist_freq) == 0)
            logs = step_lib.train_step(
                state, batch, dataclasses.replace(hp, log_hist=want_hist),
                dataclasses.replace(base_lcfg, depth_sampling=mode, feature_samples=s),
                w, sh, generator=gen)
            step_num = state.step

            hists = {k: logs.pop(k) for k in list(logs) if k.startswith("hist/")}
            if tb_writer is not None:
                for key, val in hists.items():
                    tb_writer.add_histogram(key.split("/", 1)[1], val.cpu().numpy(), step_num)

            if step_num % cfg.scalar_log_freq == 0:
                pending_logs = (step_num, logs)  # fetched lazily, off the hot path
            if main_rank and pending_logs and step_num % (cfg.scalar_log_freq * 5) == 0:
                sn, lg = pending_logs
                host = {k: float(v) for k, v in lg.items()}
                host.update({"step": sn, "cfg/depth_feat_weight": w,
                             "cfg/depth_feat_shift": sh, "cfg/feature_samples": s,
                             "steps_per_sec": cfg.scalar_log_freq * 5 / (time.time() - t_last)})
                t_last = time.time()
                log_file.write(json.dumps(host) + "\n")
                log_file.flush()
                if tb_writer is not None:
                    for k, v in host.items():
                        tb_writer.add_scalar(k, v, sn)
                pending_logs = None

            if tb_writer is not None and step_num % 2000 == 0:
                # a new event file every 2000 steps, as the reference
                from torch.utils.tensorboard import SummaryWriter

                tb_writer.close()
                tb_writer = SummaryWriter(log_dir=tb_dir)

            if cfg.get("reset_probe_steps") is not None and step_num == cfg.reset_probe_steps:
                step_lib.reset_probes(
                    state, torch.Generator().manual_seed((seed + 1) * STEP_SEED_STRIDE - 1), hp)

            if step_num % cfg.val_freq == 0:
                tb = run_validation()
                if tb[monitor] > best_monitor:
                    best_monitor = tb[monitor]
                    save_ckpt("best", tb)
                save_topk(tb[monitor], tb)
                save_ckpt("last", tb)

    tb = run_validation()
    save_ckpt("last", tb)
    if tb_writer is not None:
        tb_writer.close()
    if main_rank:
        print(f"done. best {monitor}: {max(best_monitor, tb[monitor]):.3f}")
        print(f"checkpoints: {checkpoint_dir}")
    dist.barrier()  # rank 0's checkpoints are on disk when any rank returns
    return {"checkpoint_dir": checkpoint_dir, "log_path": log_path, "step": state.step,
            "metrics": tb,
            "last_logs": {k: float(v) for k, v in (logs or {}).items()}}


if __name__ == "__main__":
    main()
