"""Batch-axis data parallelism of the port (vhap_tpu_torch/parallel/
sharding.py), case for case with tests/test_sharding.py, on the CPU: the
workers are gloo processes (one torch thread each, a file rendezvous under
tmp_path, a 60 s collective timeout and a join limit), spawned once per
group by a module fixture that runs every check and returns its arrays.

References: JAX's value_and_grad on the same numpy inputs, the batch padded
by JAX's own pad_batch_to_devices (E 1e-4 relative, gradients 1e-4 *
max|g| per leaf, the port's whole-step tolerances), and the port's own
one-process run (E 1e-6 relative, gradients 1e-5 * max|g|: only the order
of summation differs). JAX is jitted here for the landmark energy, which
has no render: on these inputs its jitted gradients sit within 1.6e-7 *
max|g| of the eager ones. The photometric stages on 2 ranks against eager
JAX are in tests/test_torch_train.py, beside the one-process case whose
JAX reference they share.
"""

import functools
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_sharding_cases as C
from vhap_tpu_torch.parallel import sharding

TIMEOUT, JOIN = 60, 240
# run_on_lead's group: a collective timeout that rank 0's wait outlasts
LEAD_TIMEOUT, LEAD_WAIT = 15, 18


def _launch(fn, n, tmp, *args):
    return sharding.launch(fn, ["cpu"] * n, "gloo", args=args,
                           init_method=(Path(tmp) / f"rdv_{fn.__name__}").as_uri(),
                           timeout=TIMEOUT, join_timeout=JOIN, num_threads=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _track_cli(root, out):
    """python -m vhap_tpu_torch.track ... --exp.num_devices 2 --device cpu,
    landmarks only, a few steps a stage."""
    from vhap_tpu_torch import track
    return track.main([
        "--data.root_folder", str(root), "--data.sequence", C.SEQ,
        "--data.background_color", "None", "--model.n_shape", "50",
        "--model.n_expr", "20", "--model.no-add-teeth", "--model.no-tex-extra",
        "--model.no-use-static-offset", "--exp.no-photometric",
        "--w.photo", "None", "--batch_size", "2", "--exp.num_devices", "2",
        "--exp.output_folder", str(out), "--device", "cpu",
        "--pipeline.lmk_init_rigid.num_steps", "2",
        "--pipeline.lmk_init_all.num_steps", "2",
        "--pipeline.lmk_sequential_tracking.num_steps", "2",
        "--pipeline.lmk_global_tracking.num_epochs", "1"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker groups and the CLI's run, spawned at once, while this
    process computes the one-process references."""
    from vhap_tpu_torch.tools.make_synthetic_multiview import generate_multiview
    from vhap_tpu_torch.tools.make_synthetic_sequence import generate
    tmp = tmp_path_factory.mktemp("sharding")
    generate_multiview(tmp / "mv", n_cams=3, n_frames=2, size=64, device="cpu")
    generate(tmp / "seq" / C.SEQ, n_frames=4, size=32, device="cpu")
    with ThreadPoolExecutor(4) as pool, pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")      # the CLI's workers' threads
        # the CLI's launch gets the tests' collective timeout and join limit
        mp.setattr(sharding, "launch", functools.partial(
            sharding.launch, timeout=TIMEOUT, join_timeout=JOIN))
        two = pool.submit(_launch, C.two_rank_checks, 2, tmp, str(tmp / "mv"),
                          str(tmp / "seq"), str(tmp / "out"))
        four = pool.submit(_launch, C.padded_checks, 4, tmp)
        cli = pool.submit(_track_cli, tmp / "seq", tmp / "cli")
        lead = pool.submit(sharding.launch, C.lead_waits, ["cpu"] * 2, "gloo",
                           args=(LEAD_WAIT,),
                           init_method=(tmp / "rdv_lead").as_uri(),
                           timeout=LEAD_TIMEOUT, join_timeout=JOIN, num_threads=1)
        th = C.port_head()
        one = {stage: C.port_loss(th, stage) for stage in C.STAGES}
        _, b5 = C.inputs(5, th.num_verts)
        one["unpadded"] = C.port_loss(th, "lmk_init_all", batch=b5)
        one["reg_diffuse"] = C.reg_diffuse_case(th, C.diffuse_image())
        one["steps"] = C.train_steps(th)
        return {"two": two.result(), "four": four.result(), "cli": cli.result(),
                "lead": lead.result(), "one": one, "tmp": tmp}


@pytest.fixture(scope="module")
def jax_lmk():
    """JAX's landmark energy and gradients (jitted) on the 2-frame batch and
    on the 5-frame batch padded to 4 devices."""
    import jax
    import jax.numpy as jnp

    from vhap_tpu.config.base import BaseTrackingConfig as JConfig
    from vhap_tpu.model.assets import load_flame_assets
    from vhap_tpu.model.flame import FlameHead, FlameTexPainted
    from vhap_tpu.parallel.sharding import pad_batch_to_devices
    from vhap_tpu.tracker import energy as JE
    from vhap_tpu.tracker import optim as JO
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    jh = FlameHead.build(n_shape=C.NS, n_expr=C.NE, assets=a, add_teeth=False,
                         face_clusters=JConfig().model.tex_clusters)
    out = {}
    for name, B in (("two", 2), ("padded", 5)):
        p, batch = C.inputs(B, jh.num_verts)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if name == "padded":
            jb = pad_batch_to_devices(jb, 4)
            assert jb["weight"].shape[0] == 8
        cfg = C.configure(JConfig(), "lmk_init_all")
        en = JE.make_energy_fn(jh, cfg, JE.make_albedo_fn(cfg, FlameTexPainted(
            a.tex_painted, C.R), None), (C.H, C.W), C.T, "lmk_init_all")
        leaves = JO.stage_optimizable_leaves(cfg, "lmk_init_all", p)
        frozen = {k: jnp.asarray(v) for k, v in p.items() if k not in leaves}

        def loss(op, en=en, frozen=frozen, jb=jb):
            E, (log, _) = en({**frozen, **op}, jb, jax.random.PRNGKey(0))
            return E, log

        (E, log), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            {k: jnp.asarray(p[k]) for k in leaves})
        out[name] = (float(E), {k: float(v) for k, v in log.items()},
                     {k: np.asarray(v) for k, v in g.items()})
    return out


def _sum_ranks(results):
    """(E, log) summed over the ranks' shares, and rank 0's gradients, which
    must equal every other rank's bit for bit."""
    E = sum(r[0] for r in results)
    log = {k: sum(r[1][k] for r in results) for k in results[0][1]}
    for r in results[1:]:
        for k, g in results[0][2].items():
            np.testing.assert_array_equal(r[2][k], g, err_msg=k)
    return E, log, results[0][2]


def _close(got, ref, e_rtol, g_tol):
    (E, log, g), (E_ref, log_ref, g_ref) = got, ref
    np.testing.assert_allclose(E, E_ref, rtol=e_rtol)
    assert set(log) == set(log_ref)
    for k in log_ref:
        np.testing.assert_allclose(log[k], log_ref[k], rtol=e_rtol, atol=1e-9, err_msg=k)
    assert set(g) == set(g_ref)
    for k in g_ref:
        scale = np.abs(g_ref[k]).max()
        assert scale > 0, k
        err = np.abs(g[k] - g_ref[k]).max()
        assert err <= g_tol * scale, (k, err / scale)


# ---------------------------------------------------------------------------
# pad_batch_to_devices / shard_batch (tests/test_sharding.py:25-39)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_pad_batch_to_devices(kind):
    batch = {"rgb": np.ones((5, 4, 4, 3), np.float32),
             "timestep_index": np.arange(5, dtype=np.int32),
             "weight": np.ones(5, np.float32)}
    if kind == "torch":
        batch = C.to_torch(batch)
    out = sharding.pad_batch_to_devices(batch, 8)
    assert all(v.shape[0] == 8 for v in out.values())
    np.testing.assert_array_equal(np.asarray(out["weight"]), [1, 1, 1, 1, 1, 0, 0, 0])
    # padding rows repeat the last real row
    np.testing.assert_array_equal(np.asarray(out["timestep_index"]), [0, 1, 2, 3, 4, 4, 4, 4])
    # already divisible -> the same object
    assert sharding.pad_batch_to_devices(out, 8) is out


def test_shard_batch_contiguous_blocks():
    batch = {"x": np.arange(12).reshape(6, 2), "weight": np.ones(6)}
    parts = [sharding.shard_batch(batch, r, 3)["x"] for r in range(3)]
    np.testing.assert_array_equal(np.concatenate(parts), batch["x"])
    np.testing.assert_array_equal(parts[1], [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="divide"):
        sharding.shard_batch(batch, 0, 4)
    # 16 views over 3 ranks: 18 rows, rank 2 holds views 12-15 and two pads
    rows = sharding.shard_padded({"v": np.arange(16), "weight": np.ones(16)}, 2, 3)
    np.testing.assert_array_equal(rows["v"], [12, 13, 14, 15, 15, 15])
    np.testing.assert_array_equal(rows["weight"], [1, 1, 1, 1, 0, 0])


def test_helpers_are_the_identity_without_a_group():
    assert not dist.is_initialized()
    assert (sharding.rank(), sharding.world()) == (0, 1)
    x = torch.arange(4.0)
    assert sharding.all_reduce_sum(x) is x and sharding.all_gather_rows(x) is x
    g = {"a": x}
    assert sharding.all_reduce_grads(g) is g and sharding.replicate_tree(g) is g
    assert sharding.broadcast_object("p") == "p"


# ---------------------------------------------------------------------------
# the global normalizers (test_sharding.py:62-95): E and every gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", C.STAGES)
def test_two_ranks_match_one_process(runs, stage):
    """Each rank's E and log are its shares: summed they are the batch's;
    the all-reduced gradients are the batch's on both ranks. The sequential
    stage (photometric area, reg_diffuse, the offset regularizers, the
    batch-free terms) is the one that catches a local denominator."""
    got = _sum_ranks([r[stage] for r in runs["two"]])
    _close(got, runs["one"][stage], 1e-6, 1e-5)
    # each rank's own share is not the whole
    assert abs(runs["two"][0][stage][0] - got[0]) > 1e-3 * abs(got[0])


def test_two_ranks_match_jax_landmarks(runs, jax_lmk):
    _close(_sum_ranks([r["lmk_init_all"] for r in runs["two"]]), jax_lmk["two"],
           1e-4, 1e-4)


def test_reg_diffuse_max_on_rank_1(runs):
    """The batch's max lies in rank 1's rows: the relu(max - 1) term and its
    gradient appear once, on rank 1's rows; the sum equals one process."""
    (e0, g0), (e1, g1) = (r["reg_diffuse"] for r in runs["two"])
    e, g = runs["one"]["reg_diffuse"]
    np.testing.assert_allclose(e0 + e1, e, rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([g0, g1]), g, rtol=0,
                               atol=1e-6 * np.abs(g).max())
    d = C.diffuse_image()
    at = np.unravel_index(np.argmax(d[1]), d[1].shape)
    other = np.unravel_index(np.argmax(d[0]), d[0].shape)
    # the max element's gradient carries the relu term (reg_diffuse * 1)
    # over the variance term's; rank 0's own max carries the variance's only
    assert g1[0][at] - np.median(np.abs(g1)) > 50.0
    assert abs(g0[0][other]) < 1.0


@pytest.mark.parametrize("against", ["jax_padded", "one_process_unpadded"])
def test_weight_padding_is_exact(runs, jax_lmk, against):
    """5 real frames over 4 ranks: padded to 8 with weight-0 rows, equal to
    JAX on the padded batch and to one process on the 5 frames
    (test_sharding.py:206-233)."""
    got = _sum_ranks(runs["four"])
    if against == "jax_padded":
        _close(got, jax_lmk["padded"], 1e-4, 1e-4)
    else:
        _close(got, runs["one"]["unpadded"], 1e-6, 1e-5)


# ---------------------------------------------------------------------------
# the disturbance pool is the whole batch's
# ---------------------------------------------------------------------------

def test_disturbance_pool_spans_ranks(runs):
    """Rank 0's cluster is red, rank 1's blue; at rate 1 rank 0's swapped
    pixels come from both, each at 0.5 +- 0.1."""
    for r, own in ((0, [1.0, 0.0, 0.0]), (1, [0.0, 0.0, 1.0])):
        px = runs["two"][r]["two_colour"][0, ..., :3].reshape(-1, 3)
        red = np.all(np.abs(px - [1.0, 0.0, 0.0]) < 1e-2, axis=1).mean()
        blue = np.all(np.abs(px - [0.0, 0.0, 1.0]) < 1e-2, axis=1).mean()
        assert red + blue == 1.0
        assert abs(red - 0.5) <= 0.1 and abs(blue - 0.5) <= 0.1, (r, red, blue)


@pytest.mark.parametrize("check", ["same_cluster", "rate", "alpha", "padding_never_a_source"])
def test_disturbance_distribution(runs, check):
    ins = [C.disturbance_inputs(r) for r in range(2)]
    outs = [runs["two"][r]["distribution"] for r in range(2)]
    rgba = np.concatenate([i[0] for i in ins])
    cid = np.concatenate([i[2] for i in ins])
    valid = np.concatenate([i[3] for i in ins]) > 0
    out = np.concatenate(outs)
    if check == "alpha":
        np.testing.assert_array_equal(out[..., 3], rgba[..., 3])
        np.testing.assert_array_equal(out[cid == 1], rgba[cid == 1])
    elif check == "padding_never_a_source":
        assert (np.abs(out[valid][..., :3] - 1.9) > 0.05).all()
        assert (np.abs(out[~valid][cid[~valid] >= 2][..., :3] - 1.9) > 0.05).mean() > 0.3
    elif check == "same_cluster":
        # every swapped pixel (padding rows' too) holds a colour of its own
        # cluster from the real rows of either rank
        swapped = np.abs(out[..., :3] - rgba[..., :3]).max(-1) > 1e-3
        for c in (2, 3):
            pool = rgba[valid][cid[valid] == c][:, :3]
            got = out[swapped & (cid == c)][:, :3]
            d = np.abs(got[:, None] - pool[None]).max(-1).min(1)
            assert len(got) > 100 and d.max() < 1e-2, (c, len(got), d.max())
    else:
        m = valid[:, None, None] & (cid >= 2)
        changed = np.abs(out[m][:, :3] - rgba[m][:, :3]).max(-1) > 1e-3
        sigma = np.sqrt(0.25 / changed.size)
        assert abs(changed.mean() - 0.5) <= 3 * sigma, (changed.mean(), sigma)


# ---------------------------------------------------------------------------
# train steps (test_sharding.py:172-203)
# ---------------------------------------------------------------------------

def test_train_steps_keep_replicas_identical(runs):
    a, b = (r["steps"]["params"] for r in runs["two"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_steps_descend_like_one_process(runs):
    """3 steps with the disturbance on (each rank its own generator): the
    energy (disturbance off) falls and ends within 5e-3 of one process's."""
    E0 = sum(r["steps"]["E0"] for r in runs["two"])
    E1 = sum(r["steps"]["E1"] for r in runs["two"])
    one = runs["one"]["steps"]
    np.testing.assert_allclose(E0, one["E0"], rtol=1e-6)
    assert E1 < E0
    np.testing.assert_allclose(E1, one["E1"], rtol=5e-3)


@pytest.mark.parametrize("check", ["stays_eager_under_gloo", "spans_nest", "bytes_by_caller"])
def test_sharded_step_instruments(runs, check):
    """The tracker's graphed step on two gloo ranks (train_steps' last
    step): it runs eager, as gloo reduces on the host, with the ranks'
    agreement a working collective, and it would stay eager on a card;
    each collective is a `sharding.all_reduce` span inside the layer it
    serves; the step's collectives counted by caller are the bytes
    torch.distributed reduced."""
    one = runs["one"]["steps"]
    for st in [r["steps"] for r in runs["two"]]:
        t = st["tally"]
        if check == "stays_eager_under_gloo":
            assert st["graph"] == {"captures": 0, "replays": 0, "eager": 3}
            assert st["capturable"] is False and st["agree"] == [True, False]
            # inputs on one card, as gloo on CUDA tensors has them: still
            # eager under gloo, captured without a group
            assert st["may_capture_on_card"] is False and one["may_capture_on_card"] is True
            # one process: the CPU keeps the eager step; no collective
            assert one["graph"] == st["graph"] and one["capturable"] is True
            assert one["reduced"] == one["span_parents"] == [] and one["tally"] == {}
        elif check == "spans_nest":
            parents = st["span_parents"]
            assert len(parents) == len(st["reduced"]) == sum(v["calls"] for v in t.values())
            assert sorted(set(parents)) == ["render.disturb", "step.backward", "step.forward"]
            assert parents.count("render.disturb") == parents.count("step.backward") == 1
        else:
            assert sorted(t) == ["disturb_pool", "grads", "max_rank", "other"]
            assert t["grads"] == {"calls": 1, "bytes": st["grad_bytes"]}
            assert t["disturb_pool"] == {"calls": 1, "bytes": st["pool_bytes"]}
            assert t["max_rank"] == {"calls": 1, "bytes": 2 * 4}
            # the energy's normalizers: float32 scalars
            assert t["other"]["calls"] >= 2 and t["other"]["bytes"] == 4 * t["other"]["calls"]
            assert sorted(st["reduced"]) == sorted(
                [st["grad_bytes"], st["pool_bytes"], 8] + [4] * t["other"]["calls"])


# ---------------------------------------------------------------------------
# GlobalTracker (test_sharding.py:236-305)
# ---------------------------------------------------------------------------

def test_tracker_shards_multiview(runs):
    """3 cameras padded to 4 rows, 2 per rank, weights [1, 1, 1, 0]; a
    stage runs and its parameters stay finite and identical."""
    m0, m1 = (r["mv"] for r in runs["two"])
    assert m0["rows"] == m1["rows"] == 2
    np.testing.assert_array_equal(m0["global_weight"], [1, 1, 1, 0])
    np.testing.assert_array_equal(np.concatenate([m0["weight"], m1["weight"]]), [1, 1, 1, 0])
    # rank 1's padding row repeats its last real view, with its camera
    np.testing.assert_array_equal(m1["views"][1], m1["views"][0])
    assert not np.array_equal(m0["views"][0], m1["views"][0])
    for k in m0["params"]:
        assert np.isfinite(m0["params"][k]).all()
        np.testing.assert_array_equal(m0["params"][k], m1["params"][k])


def test_tracker_only_rank_0_writes(runs):
    m0, m1 = (r["mono"] for r in runs["two"])
    assert m0["a_out"] == m1["a_out"]
    out = Path(m0["a_out"])
    names = {p.name for p in out.iterdir()}
    assert {"config.yml", "run.log", "run_state.npz"} <= names
    assert "tracked_flame_params_0.npz" in names
    assert "scalars.jsonl" in names or any(n.startswith("events.out") for n in names)
    assert list((out / "eval_0" / "image_grid").glob("frame_*.jpg"))
    # one run folder each for the run and its resume, both rank 0's
    assert len(list(out.parent.iterdir())) == 2
    assert m1["writes"] == [], m1["writes"]
    z = np.load(out / "run_state.npz")
    assert z["key"].shape[0] == 2 and z["key"].dtype == np.uint8


def test_tracker_resume_continues_both_generators(runs):
    for r in runs["two"]:
        m = r["mono"]
        assert m["b_steps"] == {"rgb_global_tracking": m["steps"]["rgb_global_tracking"]}
        np.testing.assert_array_equal(m["a_gen"], m["b_gen"])
        for k in m["a"]:
            np.testing.assert_array_equal(m["a"][k], m["b"][k], err_msg=k)
    a0, a1 = (r["mono"]["a"] for r in runs["two"])
    for k in a0:
        assert np.isfinite(a0[k]).all()
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)


def test_num_devices_one_makes_no_group(runs, tmp_path, monkeypatch):
    from vhap_tpu_torch.tracker import tracker as TT
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    monkeypatch.setattr(TT, "ScalarWriter", lambda out: TT._NullWriter())
    cfg = C.mono_config(runs["tmp"] / "seq", tmp_path / "out1", num_devices=1)
    tr = GlobalTracker(cfg)
    assert not dist.is_initialized() and tr.world == 1
    batch = tr._make_batch([0, 1])
    assert batch["rgb"].shape[0] == 2 and "global_weight" not in batch
    assert sharding.plan(1, "cpu") == (["cpu"], "gloo")
    assert sharding.plan(0, "cpu") == (["cpu"], "gloo")
    assert sharding.plan(3, "cpu") == (["cpu"] * 3, "gloo")
    cfg.exp.num_devices = 2
    with pytest.raises(RuntimeError, match="one process per device"):
        GlobalTracker(cfg)


def test_num_devices_zero_means_every_card(runs, tmp_path, monkeypatch):
    """On a host with 4 cards, exp.num_devices 0 asks for all 4, whoever
    builds the tracker: a tracker built directly, outside a process group,
    raises as it does for num_devices 2."""
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [f"cuda:{i}" for i in range(4)]
    assert sharding.plan(0) == (cards, "nccl")
    assert sharding.plan(6) == (cards, "nccl")
    assert sharding.plan(2) == (cards[:2], "nccl")
    assert sharding.plan(1) == (["cuda"], "nccl")
    cfg = C.mono_config(runs["tmp"] / "seq", tmp_path / "out", num_devices=0)
    with pytest.raises(RuntimeError, match="one process per device.*num_devices=1"):
        GlobalTracker(cfg, "cuda")


def test_media_failure_raises_only_under_a_group(runs, tmp_path, monkeypatch):
    """A failing media log warns in one process and raises on every rank of
    a group, where a rank that went on would leave the others waiting in
    its collectives."""
    from vhap_tpu_torch.tracker import tracker as TT
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    assert [r["mv"]["media_failure"] for r in runs["two"]] == ["eval energy failed"] * 2
    monkeypatch.setattr(TT, "ScalarWriter", lambda out: TT._NullWriter())
    tr = GlobalTracker(C.mono_config(runs["tmp"] / "seq", tmp_path / "out", num_devices=1))
    tr._eval_energy = C.failing_energy
    tr._log_media(tr._make_batch([0, 1]), "lmk_init_rigid")


def test_run_on_lead_outlasts_the_collective_timeout(runs):
    """Rank 0's fn outlasts the group's collective timeout and every rank
    waits for it; when fn raises, rank 0 raises its error and rank 1 a
    RuntimeError."""
    (w0, e0), (w1, e1) = runs["lead"]
    assert w0 >= LEAD_WAIT and w1 > LEAD_TIMEOUT
    assert e0 == "ValueError: rank 0 fails"
    assert e1 == "RuntimeError: rank 0 failed in run_on_lead"


def test_track_cli_launches_two_processes(runs):
    """python -m vhap_tpu_torch.track ... --exp.num_devices 2 --device cpu
    runs two gloo processes; main() returns rank 0's summary."""
    out = runs["cli"]
    assert out["rank"] == 0 and out["world"] == 2
    assert out["global_step"] == 2 + 2 + 2 * 2 + 2
    assert sorted(Path(out["out_dir"]).glob("tracked_flame_params_*.npz"))


def test_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        _launch(C.fails_on_rank_1, 2, tmp_path)
