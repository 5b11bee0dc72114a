"""The port's TGN offline training entry point and what it stands on:
early stopping, memory reset/backup/restore, checkpoints, the model
factory, ``build_dynamic_graph`` and the pandas-free ``edges.csv``
loader (each against the JAX package where it has a counterpart), and two
epochs of ``python -m gnnflow_tpu_torch.scripts.offline_edge_prediction``
on the CPU; then its feature-cache path, serial and pipelined."""
import logging
import os

import numpy as np
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.utils import EarlyStopMonitor as JEarlyStopMonitor
from gnnflow_tpu_torch import config, data
from gnnflow_tpu_torch.dynamic_graph import (DynamicGraph,
                                             build_dynamic_graph)
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.factory import build_model
from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
from gnnflow_tpu_torch.train import Trainer
from gnnflow_tpu_torch.utils import EarlyStopMonitor
from gnnflow_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from torch_fixtures import one_cpu_thread  # noqa: F401
from torch_fixtures import CFG
from torch_parity import _assert_tables_equal


@pytest.mark.parametrize("higher_better", [True, False])
def test_early_stop_matches_jax(higher_better):
    vals = [0.5, 0.6, 0.6, 0.59, 0.61, 0.61, 0.6, 0.58, 0.57, 0.56, 0.7,
            0.7, 0.69, 0.68, 0.67, 0.66, 0.65]
    ours = EarlyStopMonitor(max_round=4, higher_better=higher_better)
    ref = JEarlyStopMonitor(max_round=4, higher_better=higher_better)
    for v in vals:
        assert ours.early_stop_check(v) == ref.early_stop_check(v)
        assert (ours.num_round, ours.best_epoch, ours.last_best) == \
            (ref.num_round, ref.best_epoch, ref.last_best)


def _filled_memory(seed=0):
    mem = memory_lib.init_memory(30, 8, 6, "cpu")
    gen = torch.Generator().manual_seed(seed)
    for name in ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts"):
        t = getattr(mem, name)
        t.copy_(torch.randn(t.shape, generator=gen))
    return mem


def test_memory_backup_restore_reset():
    mem = _filled_memory()
    bk = memory_lib.backup_memory(mem)
    restored = memory_lib.restore_memory(bk, "cpu")
    assert memory_lib.reset_memory(mem) is mem
    for name in ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts"):
        assert not getattr(mem, name).any(), name
        # the backup is a copy, not a view of the reset tensors
        assert torch.equal(getattr(restored, name), bk[name]), name
        assert bk[name].abs().sum() > 0, name


def test_checkpoint_round_trip(tmp_path):
    model = DGNN(**CFG, seed=3, device="cpu")
    mem = _filled_memory(1)
    path = str(tmp_path / "sub" / "TGN_torch.ckpt")
    save_checkpoint(path, model.state_dict(), memory_lib.backup_memory(mem),
                    {"epoch": 2, "ap": 0.75})
    ckpt = load_checkpoint(path)
    assert ckpt["extra"] == {"epoch": 2, "ap": 0.75}
    fresh = DGNN(**CFG, seed=4, device="cpu")
    fresh.load_state_dict(ckpt["params"])
    for (n, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), n
    back = memory_lib.restore_memory(ckpt["memory"], "cpu")
    for name in ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts"):
        assert torch.equal(getattr(back, name), getattr(mem, name)), name
    assert not os.path.exists(path + ".tmp")


def test_load_dataset_matches_jax(tmp_path):
    """A pandas-written ``edges.csv`` (index column) and one without the
    index column (edge ids are row numbers), with their feature files."""
    jdata.write_synthetic_dataset(str(tmp_path / "TINY"), num_src=40,
                                  num_dst=15, num_edges=500, dim_node=3,
                                  dim_edge=4, seed=2, time_scale=3.3)
    full = jdata.load_dataset("TINY", str(tmp_path))[3]
    os.makedirs(tmp_path / "BARE")
    ext = np.repeat([0, 1, 2], [300, 100, 100])
    with open(tmp_path / "BARE" / "edges.csv", "w") as f:
        f.write("src,dst,time,ext_roll\n")
        for s, d, t, e in zip(full.src, full.dst, full.time, ext):
            f.write(f"{s},{d},{t},{e}\n")
    for name in ("TINY", "BARE"):
        ours = data.load_dataset(name, str(tmp_path))
        ref = jdata.load_dataset(name, str(tmp_path))
        for a, b in zip(ours, ref):
            _assert_tables_equal(a, b)
        assert [len(t) for t in ours] == [len(t) for t in ref]
        for a, b in zip(data.load_feat(name, str(tmp_path)),
                        jdata.load_feat(name, str(tmp_path))):
            assert (a is None and b is None) or np.array_equal(a, b)
    assert [len(t) for t in data.load_dataset("BARE", str(tmp_path))] == \
        [300, 100, 100, 500]
    with pytest.raises(ValueError, match="does not exist"):
        data.load_dataset("MISSING", str(tmp_path))


def test_build_dynamic_graph_from_data_configs():
    _, data_cfg = config.get_default_config("tgn", "reddit")
    g = build_dynamic_graph(**data_cfg)
    assert isinstance(g, DynamicGraph)
    assert g.minimum_block_size == data_cfg["minimum_block_size"]
    assert g.placement == "hbm"
    # GDELT's config places the store on the host (a small pool here)
    _, gdelt = config.get_default_config("tgn", "gdelt")
    assert build_dynamic_graph(**{**gdelt, "initial_pool_size": 4096}
                               ).placement == "host"
    # the REPLACE policy reaches the store (held to JAX's in
    # tests/test_torch_variants.py)
    g = build_dynamic_graph(**{**data_cfg, "insertion_policy": "replace"})
    assert g.insertion_policy == "replace"


@pytest.mark.parametrize("name, change", [
    pytest.param("dysat", {"neg_sample_ratio": 2}, id="dysat"),
    pytest.param("apan", {"dim_time": 0}, id="apan"),
    pytest.param("graphsage", {"neg_sample_ratio": 2}, id="graphsage"),
    pytest.param("gat", {"neg_sample_ratio": 3}, id="gat")])
def test_build_model_names_the_roadmap_item(name, change):
    """Configurations that earlier slices refused build as JAX's factory
    builds them, with the same trainer kwargs: the DGNN family carries the
    negatives per edge to its predictor and its trainer, GraphSAGE and
    static GAT are built without them (``static.py:184, 238``), and APAN
    without time encoding has no updater time encoding."""
    from gnnflow_tpu.models.factory import build_model as jbuild_model
    cfg, _ = config.get_default_config(name, "synthetic")
    model, kw = build_model(name, {**cfg, **change}, 4, 6, device="cpu")
    jmodel, jkw = jbuild_model(name, {**cfg, **change}, 4, 6)
    assert kw == jkw
    assert getattr(model, "neg_sample_ratio", 1) == \
        getattr(jmodel, "neg_sample_ratio", 1)
    Trainer(model, device="cpu", **kw)
    if name == "apan":
        assert not hasattr(model.updater, "time_enc")


def test_build_model_tgn():
    cfg, _ = config.get_default_config("tgn", "synthetic")
    model, kw = build_model("TGN", cfg, 0, 6, seed=1, device="cpu")
    assert kw == {"fanouts": [10], "sample_strategy": "recent",
                  "num_snapshots": 1, "snapshot_time_window": 0,
                  "prop_time": False, "is_static": False,
                  "neg_sample_ratio": 1}
    assert model.dim_memory == 100
    model, kw = build_model("tgn", {**cfg, "neg_sample_ratio": 2}, 0, 6,
                            device="cpu")
    assert kw["neg_sample_ratio"] == model.edge_predictor.neg_ratio == 2


def test_build_model_apan():
    cfg, _ = config.get_default_config("apan", "synthetic")
    model, kw = build_model("APAN", cfg, 0, 6, seed=1, device="cpu")
    assert kw == {"fanouts": [10], "sample_strategy": "recent",
                  "num_snapshots": 1, "snapshot_time_window": 0,
                  "prop_time": False, "is_static": False,
                  "neg_sample_ratio": 1}
    assert (model.memory_updater, model.mailbox_slots) == ("transformer", 10)
    trainer = Trainer(model, device="cpu", **kw)
    assert trainer.apan_table
    mem = trainer.init_state(30).memory
    assert mem.mailbox.shape == (30, 10, 206)
    assert mem.mailbox_ts.shape == (30, 10)


@pytest.mark.parametrize("flags", [["--remat-attention"], ["--use-scan"]])
def test_entry_refuses_unported_flags(flags, tmp_path, caplog):
    """The flags an earlier slice refused run: ``--remat-attention``
    recomputes the attention layers, ``--use-scan`` trains each epoch's
    staged batches in one ``train_steps_scan`` call and logs the last
    loss (both held to the plain steps bit for bit in
    tests/test_torch_variants.py)."""
    with caplog.at_level(logging.INFO):
        out = entry.main(["--model", "TGN", "--data", "SYNTHETIC",
                          "--epoch", "1", "--synthetic-edges", "800",
                          "--synthetic-dim-edge", "16", "--num-chunks", "1",
                          "--device", "cpu", *flags],
                         checkpoint_path=str(tmp_path / "TGN_torch.ckpt"))
    for v in out["val_ap"] + [out["test_ap"]]:
        assert 0.0 < v <= 1.0
    msgs = [r.getMessage() for r in caplog.records]
    assert any("last loss" in m for m in msgs) == (flags == ["--use-scan"])


def test_entry_refuses_a_config_with_more_negatives(monkeypatch, capsys):
    """The script draws one negative per edge, as JAX's, whose steps then
    fail on the roots' shapes; a config with more says so."""
    real = config.get_default_config

    def more_negatives(*a, **k):
        model_cfg, data_cfg = real(*a, **k)
        return {**model_cfg, "neg_sample_ratio": 3}, data_cfg

    monkeypatch.setattr(entry, "get_default_config", more_negatives)
    with pytest.raises(SystemExit):
        entry.main(["--model", "TGN", "--data", "SYNTHETIC",
                    "--device", "cpu"])
    assert "neg_sample_ratio=3" in capsys.readouterr().err


def test_entry_passes_memory_storage(monkeypatch):
    """``--memory-storage bfloat16`` reaches the trainer, which stores
    memory in bf16 (held against JAX in tests/test_torch_distmem.py)."""
    seen = {}

    class Built(Exception):
        pass

    def trainer(model, **kwargs):
        seen.update(kwargs)
        raise Built

    monkeypatch.setattr(entry, "Trainer", trainer)
    with pytest.raises(Built):
        entry.main(["--model", "TGN", "--data", "SYNTHETIC",
                    "--synthetic-edges", "500", "--memory-storage",
                    "bfloat16", "--device", "cpu"])
    assert seen["memory_storage"] == "bfloat16"


def test_entry_trains_two_epochs_on_cpu(tmp_path, caplog):
    path = str(tmp_path / "TGN_torch.ckpt")
    with caplog.at_level(logging.INFO):
        out = entry.main(["--model", "TGN", "--data", "SYNTHETIC",
                          "--epoch", "2", "--synthetic-edges", "3000",
                          "--synthetic-dim-edge", "16", "--device", "cpu"],
                         checkpoint_path=path)
    assert len(out["val_ap"]) == 2 and len(out["val_auc"]) == 2
    for v in out["val_ap"] + out["val_auc"] + [out["test_ap"],
                                               out["test_auc"]]:
        assert 0.0 < v <= 1.0
    msgs = [r.getMessage() for r in caplog.records]
    assert sum("val ap" in m for m in msgs) == 2
    assert any(m.startswith("Test ap:") for m in msgs)
    assert any("auto-calibration" in m for m in msgs)
    ckpt = load_checkpoint(path)
    assert ckpt["extra"]["epoch"] == out["best_epoch"]
    assert ckpt["extra"]["ap"] == max(out["val_ap"])
    assert set(ckpt["memory"]) == {"node_memory", "node_memory_ts",
                                   "mailbox", "mailbox_ts", "mailbox_ptr"}


def test_entry_trains_apan_on_cpu(tmp_path, caplog):
    """One epoch of ``--model APAN``: the first step calibrates the memory
    dedup by the transformer's rule, and the best checkpoint's memory
    backup carries the 10 mail slots and their cursors.  ``--num-chunks
    1`` starts the epoch at the first edge, so the 2,100 train edges make
    one (padded) batch of 4,000."""
    path = str(tmp_path / "APAN_torch.ckpt")
    with caplog.at_level(logging.INFO):
        out = entry.main(["--model", "APAN", "--data", "SYNTHETIC",
                          "--epoch", "1", "--synthetic-edges", "3000",
                          "--synthetic-dim-edge", "16", "--num-chunks", "1",
                          "--device", "cpu"], checkpoint_path=path)
    for v in out["val_ap"] + [out["test_ap"]]:
        assert 0.0 < v <= 1.0
    msgs = [r.getMessage() for r in caplog.records]
    assert any("auto-calibration" in m and "'dedup_factor': 0." in m
               for m in msgs)
    assert any("epoch 0: time" in m and "throughput 0 " not in m
               for m in msgs)
    mem = load_checkpoint(path)["memory"]
    assert mem["mailbox"].shape[1:] == (10, 216)
    assert mem["mailbox_ts"].shape[1:] == (10,)
    assert int(mem["mailbox_ptr"].max()) >= 1


@pytest.mark.parametrize("model", ["GRAPHSAGE", "GAT"])
def test_entry_trains_static_models_on_cpu(tmp_path, caplog, model):
    """Two epochs of ``--model GRAPHSAGE`` and ``--model GAT`` on the
    synthetic stream, which carries 100-dim node features for them: the
    first step calibrates the layer dedup, every AP is finite."""
    path = str(tmp_path / f"{model}_torch.ckpt")
    with caplog.at_level(logging.INFO):
        out = entry.main(["--model", model, "--data", "SYNTHETIC",
                          "--epoch", "2", "--synthetic-edges", "3000",
                          "--synthetic-dim-edge", "16", "--device", "cpu"],
                         checkpoint_path=path)
    assert len(out["val_ap"]) == 2
    for v in out["val_ap"] + out["val_auc"] + [out["test_ap"],
                                               out["test_auc"]]:
        assert 0.0 < v <= 1.0
    msgs = [r.getMessage() for r in caplog.records]
    assert any("auto-calibration" in m for m in msgs)
    assert sum("layer-dedup takes" in m for m in msgs) == 2
    params = load_checkpoint(path)["params"]
    assert params["layers.l0h0.fc_self.kernel" if model == "GRAPHSAGE"
                  else "layers.l0h0.fc.kernel"].shape[0] == 100


def test_entry_trains_tgn_with_node_features_on_cpu(tmp_path):
    """``--model TGN`` on a dataset on disk with node features, one epoch:
    the model takes them through ``node_feat_proj`` (8 wide into memory
    of 100)."""
    jdata.write_synthetic_dataset(str(tmp_path / "REDDIT"), num_src=100,
                                  num_dst=30, num_edges=2000, dim_node=8,
                                  dim_edge=16, seed=3)
    path = str(tmp_path / "TGN_torch.ckpt")
    out = entry.main(["--model", "TGN", "--data", "REDDIT", "--data-dir",
                      str(tmp_path), "--epoch", "1", "--device", "cpu"],
                     checkpoint_path=path)
    assert len(out["val_ap"]) == 1
    for v in out["val_ap"] + [out["test_ap"]]:
        assert 0.0 < v <= 1.0
    params = load_checkpoint(path)["params"]
    assert params["updater.node_feat_proj.kernel"].shape == (8, 100)


# --calibrate puts the prefetched steps on the memory dedup, which keeps
# the GRU's plain version on the CPU short
CACHE = ["--model", "TGN", "--data", "SYNTHETIC", "--epoch", "1",
         "--synthetic-edges", "3000", "--synthetic-dim-edge", "16",
         "--num-chunks", "1", "--cache", "LRUCache", "--edge-cache-ratio",
         "0.3", "--calibrate", "--device", "cpu"]


@pytest.fixture(scope="module")
def cache_runs(tmp_path_factory):
    """One epoch of the cache path with the tables kept on the host,
    serial and pipelined: ``{mode: (out, log messages)}``."""
    runs = {}
    root = logging.getLogger()
    level = root.level
    for mode, extra in (("serial", []), ("pipeline", ["--pipeline"])):
        path = str(tmp_path_factory.mktemp(mode) / "TGN_torch.ckpt")
        handler = _Collect()
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        try:
            out = entry.main(CACHE + ["--features-on-host"] + extra,
                             checkpoint_path=path)
        finally:
            root.removeHandler(handler)
            root.setLevel(level)
        runs[mode] = (out, handler.messages)
    return runs


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("mode", ["serial", "pipeline"])
def test_entry_cache_path_on_cpu(cache_runs, mode):
    """The cache path logs its size, the epoch's phases (sample, feature
    and train when serial; train when pipelined) and hit ratios, and
    returns them; every AP is finite."""
    out, msgs = cache_runs[mode]
    for v in out["val_ap"] + out["val_auc"] + [out["test_ap"],
                                               out["test_auc"]]:
        assert 0.0 < v <= 1.0
    assert any(m.startswith("cache mem size:") for m in msgs)
    assert any(m.startswith("calibration:") and "'dedup_factor': 0." in m
               for m in msgs)
    assert sum(m.startswith("cache node hit") for m in msgs) == 1
    assert any(m.startswith("epoch 0 phases: ") for m in msgs)
    assert 0.0 < out["cache_edge_hit"][0] <= 1.0
    assert out["cache_node_hit"] == [0.0]       # no node features
    want = {"train"} if mode == "pipeline" else {"sample", "feature",
                                                 "train"}
    assert set(out["phases"][0]) == want


def test_entry_pipeline_equals_serial(cache_runs):
    """The pipeline fetches on a worker thread: the same hit ratios, APs
    and AUCs as the serial loop."""
    serial, piped = cache_runs["serial"][0], cache_runs["pipeline"][0]
    for k in ("val_ap", "val_auc", "test_ap", "test_auc", "cache_edge_hit"):
        assert serial[k] == piped[k], k


def test_entry_cache_bf16_transfer_on_cpu(tmp_path):
    out = entry.main(CACHE + ["--cache-transfer-dtype", "bfloat16"],
                     checkpoint_path=str(tmp_path / "TGN_torch.ckpt"))
    assert 0.0 < out["test_ap"] <= 1.0
    assert 0.0 < out["cache_edge_hit"][0] <= 1.0


@pytest.mark.parametrize("flags, message", [
    (["--features-on-host"], "--features-on-host requires --cache"),
    (["--data", "GDELT"], "places the graph store on the host")],
    ids=["features-on-host", "host-store"])
def test_entry_cache_flags_need_cache(flags, message, capsys):
    """``--features-on-host`` without ``--cache`` is the JAX parser's
    error; a data config that places the store on the host needs
    ``--cache`` (GDELT's; missing on disk, so its stream is synthetic)."""
    argv = ["--model", "TGN", "--data", "SYNTHETIC", "--synthetic-edges",
            "3000", "--device", "cpu"]
    with pytest.raises(SystemExit):
        entry.main(argv + flags)
    assert message in capsys.readouterr().err
