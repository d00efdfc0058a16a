"""The port's Orbax reader and writer (segclip_tpu_torch/checkpoint/
{zstd,ocdbt,orbax_io}.py) against the JAX package, orbax, tensorstore and
libzstd on the CPU, all to exact equality.

  - the zstd decoder (hand-written C++, built at first use into build/) on
    frames libzstd writes (through the `zstandard` module, here only) at
    levels 1, 3 and 19, over 128 KiB, incompressible, runs of one byte,
    checksummed and without a content size, and on the chunks tensorstore's
    zarr driver writes; a corrupt frame raises;
  - the OCDBT reader against tensorstore's own KvStore on stores with small
    nodes and many commits (interior B-tree nodes, version-tree nodes,
    indirect values), compressed or not; the writer read back by it;
  - the JAX package's save_params / save_checkpoint read by the port leaf
    by leaf, bit for bit (float32, bfloat16 moments, 0-d counters),
    multi-chunk arrays from a two-device mesh (a subprocess, as the JAX
    package's parallel tests), `use_ocdbt=False`; the port's writer read by
    the JAX package's restore_params / restore_checkpoint;
  - the flax ↔ state-dict round trip; restore_checkpoint into the port's
    model and AdaptAdamW; load_model and the loop's resume from an Orbax
    directory;
  - the committed fixture (tests/make_orbax_fixture.py) against its
    recorded hashes, a fresh generation, and its JAX eval and next-step
    loss through chip_smoke.py's phase-15 functions on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import zstandard

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import tensorstore as ts

from segclip_tpu.checkpoint import orbax_io as jorbax
from segclip_tpu.checkpoint.torch_export import export_state_dict
from segclip_tpu.config import Config, OptimConfig
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip
from segclip_tpu.train.step import create_train_state

import make_orbax_fixture as fixture_maker
from test_torch_convert import chip_smoke
from test_torch_loop import corpus, read_metrics, tiny_config  # noqa: F401 (fixture)
from test_torch_train import TINY, port_config

from segclip_tpu_torch.checkpoint import io as ckpt_io
from segclip_tpu_torch.checkpoint import ocdbt, orbax_io, zstd
from segclip_tpu_torch.checkpoint.convert import (flax_params_from_state_dict, load_into,
                                                  state_dict_from_jax)
from segclip_tpu_torch.cli.common import load_model
from segclip_tpu_torch.models.segclip import SegCLIP, init_segclip
from segclip_tpu_torch.train import loop as tloop
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CFG = Config(model=TINY, optim=OptimConfig(lr=1e-3, lower_lr=1e-4,
                                                 moment_dtype="bfloat16"))
T_TOTAL = 100


def _bits(x) -> np.ndarray:
    """A leaf's exact bits: numpy of its dtype, bfloat16 as uint16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def assert_same_tree(got: dict, want: dict) -> None:
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), k


# ---- zstd ----------------------------------------------------------------

def _payload(kind: str) -> bytes:
    rng = np.random.default_rng(5)
    if kind == "float32_over_128k":
        return (rng.standard_normal(100_000) * 0.02).astype(np.float32).tobytes()
    if kind == "incompressible":
        return rng.bytes(300_000)
    if kind == "runs":
        return b"\x07" * 200_000 + b"\x00" * 70_000 + b"\x07" * 3
    if kind == "text":
        with open(os.path.join(REPO, "segclip_tpu_torch", "checkpoint", "native",
                               "zstd_decode.cc"), "rb") as f:
            return f.read() * 4
    if kind == "bfloat16":
        x = rng.standard_normal(150_000).astype(np.float32)
        return (x.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    if kind == "rle_literals":       # a second block of matches whose literals are all zero
        r = rng.bytes(140_000)
        return r + b"".join(r[i * 997 % 130_000:i * 997 % 130_000 + 60] + b"\x00"
                            for i in range(2000))
    if kind == "tiny":               # a content size in one byte
        return rng.integers(0, 3, 200, dtype=np.uint8).tobytes()
    return rng.integers(0, 3, 1000, dtype=np.uint8).tobytes()      # "small"


# Between them the frames take every block type, raw, RLE, Huffman (one
# stream and four) and treeless literals, direct and FSE-coded Huffman
# weights, predefined, RLE, FSE-coded and repeated sequence tables, all
# four repeat-offset cases, single-segment frames and window descriptors,
# content sizes of 0, 1, 2 and 4 bytes, and checksums.
KINDS = ("float32_over_128k", "incompressible", "runs", "text", "bfloat16", "rle_literals",
         "small", "tiny")


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_zstd_decodes_libzstd_frames(level, kind):
    data = _payload(kind)
    plain = zstandard.ZstdCompressor(level=level).compress(data)
    checked = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
    stream = zstandard.ZstdCompressor(level=level, write_content_size=False).compressobj()
    streamed = stream.compress(data) + stream.flush()
    assert plain[:4] == b"\x28\xb5\x2f\xfd" and checked[4] & 0x04 and not streamed[4] & 0xC0
    for frame, want in ((plain, data), (checked, data), (streamed, data),
                        (plain + checked, data * 2)):
        assert zstd.decompress(frame) == want


def test_zstd_decodes_tensorstore_zarr_chunks(tmp_path):
    """The chunk files of a zarr array written by tensorstore (a directory
    saved by orbax without OCDBT), each one of its zstd frames."""
    params = {"a": (np.random.default_rng(0).standard_normal((300, 200)) * 0.1)
              .astype(np.float32), "b": np.arange(70_000, dtype=np.int32)}
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)) as ckptr:
        ckptr.save(tmp_path / "x", {"params": params})
    frames = [tmp_path / "x" / "params.a" / "0.0", tmp_path / "x" / "params.b" / "0"]
    for path, want in zip(frames, (params["a"], params["b"])):
        raw = path.read_bytes()
        assert raw[:4] == b"\x28\xb5\x2f\xfd"
        assert zstd.decompress(raw) == zstandard.ZstdDecompressor().decompressobj() \
            .decompress(raw) == want.tobytes()


def _corrupt(kind: str) -> bytes:
    data = _payload("text")
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    if kind == "truncated":
        return bytes(frame[:len(frame) // 2])
    if kind == "bad_magic":
        frame[0] ^= 1
    elif kind == "checksum":
        frame[-1] ^= 0x40
    elif kind == "body":
        frame[len(frame) // 2] ^= 0x10
    elif kind == "reserved_bit":
        frame[4] |= 0x08
    elif kind == "dictionary":
        frame[4] = (frame[4] & ~3) | 1
        frame[5:5] = b"\x07"
    elif kind == "trailing_garbage":
        frame += b"\x01\x02\x03"
    return bytes(frame)


@pytest.mark.parametrize("kind", ["truncated", "bad_magic", "checksum", "body",
                                  "reserved_bit", "dictionary", "trailing_garbage"])
def test_zstd_raises_on_a_corrupt_frame(kind):
    with pytest.raises(ValueError, match="zstd: "):
        zstd.decompress(_corrupt(kind))


def test_crc32c_matches_the_reference_and_the_library_builds_into_build():
    import google_crc32c
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 8, 9, 63, 1000, 100_003):
        data = rng.bytes(n)
        assert zstd.crc32c(data) == google_crc32c.value(data)
    lib = zstd.library_path()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert lib.name.startswith(zstd.STEM) and lib.exists()


# ---- OCDBT ---------------------------------------------------------------

def _tensorstore(root) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(root)}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 5}],
                         ids=["uncompressed", "zstd"])
def test_ocdbt_reader_matches_tensorstore_on_deep_trees(tmp_path, compression):
    """Nodes of at most 256 bytes, values over 16 bytes out of line, a
    version tree of arity 2, and 12 commits: interior B-tree nodes,
    version-tree nodes and indirect values all appear."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 16,
                                     "version_tree_arity_log2": 1,
                                     "compression": compression}}).result()
    rng = np.random.default_rng(4)
    for commit in range(12):
        txn = ts.Transaction()
        for i in range(8):
            key = f"params.block_{commit % 5}.w{i}/{rng.integers(0, 3)}.0"
            kv.with_transaction(txn).write(key, rng.bytes(int(rng.integers(0, 60)))).result()
        if commit == 7:
            kv.with_transaction(txn).delete_range(ts.KvStore.KeyRange("params.block_1",
                                                                      "params.block_2"))
        txn.commit_async().result()
    with ocdbt.OcdbtStore(str(tmp_path)) as store:
        mine = {k: store[k] for k in store.keys()}
        heights = [v.height for v in store.versions]
        assert store.compression == (0 if compression is None else 1)
        assert len(store.versions) == store.generation >= 12
        indirect = [v for v in store._values.values() if isinstance(v, ocdbt.Ref)]
    assert mine == _tensorstore(tmp_path) and len(mine) > 40
    assert max(heights) >= 2 and indirect
    assert ocdbt.read_store(str(tmp_path)) == mine


def test_ocdbt_writer_is_read_by_tensorstore(tmp_path):
    rng = np.random.default_rng(6)
    values = {f"params.x{i}/.zarray": b"{}" for i in range(30)}
    values.update({f"params.x{i}/0.0": rng.bytes(int(rng.integers(0, 3000))) for i in range(30)})
    values["opt_step/0"] = b""
    n = ocdbt.write_store(str(tmp_path / "s"), values)
    assert _tensorstore(tmp_path / "s") == values == ocdbt.read_store(str(tmp_path / "s"))
    assert n == sum(f.stat().st_size for f in (tmp_path / "s").rglob("*") if f.is_file())
    with pytest.raises(FileExistsError):
        ocdbt.write_store(str(tmp_path / "s"), values)


def test_ocdbt_reader_raises_on_a_corrupt_file(tmp_path):
    ocdbt.write_store(str(tmp_path / "s"), {"a": b"x" * 5000, "b": b"y"})
    manifest = tmp_path / "s" / "manifest.ocdbt"
    good = manifest.read_bytes()
    manifest.write_bytes(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtStore(str(tmp_path / "s"))
    manifest.write_bytes(good[:-1])
    with pytest.raises(ValueError, match="header says"):
        ocdbt.OcdbtStore(str(tmp_path / "s"))
    manifest.write_bytes(good)
    (data,) = (tmp_path / "s" / "d").iterdir()
    raw = bytearray(data.read_bytes())
    raw[-10] ^= 4                                          # inside the leaf node
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtStore(str(tmp_path / "s"))


# ---- the JAX package writes, the port reads --------------------------------

@pytest.fixture(scope="module")
def jax_params():
    _, params = jax_init_segclip(TINY, seed=3)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_state(jax_params):
    """A TrainState with bfloat16 moments of seeded values and counters
    other than zero."""
    state, _, _ = create_train_state(TRAIN_CFG, jax_params, t_total=T_TOTAL, seed=4)
    rng = np.random.default_rng(8)

    def moment(x):
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 1e-3,
                           jnp.bfloat16)
    opt = state.opt_state._replace(mu=jax.tree_util.tree_map(moment, state.opt_state.mu),
                                   nu=jax.tree_util.tree_map(lambda x: abs(moment(x)),
                                                             state.opt_state.nu),
                                   step=jnp.asarray(7, jnp.int32))
    return state.replace(step=jnp.asarray(9, jnp.int32), opt_state=opt)


def _jax_payload(state, epoch):
    return {"params": state.params, "opt_state_mu": state.opt_state.mu,
            "opt_state_nu": state.opt_state.nu, "opt_step": state.opt_state.step,
            "step": state.step, "epoch": np.asarray(epoch, np.int32)}


def test_params_directory_reads_bit_for_bit(tmp_path, jax_params):
    path = jorbax.save_params(str(tmp_path), "params", jax_params)
    assert_same_tree(orbax_io.read_tree(path), {"params": jax_params})
    assert_same_tree(orbax_io.restore_params(path), jax_params)
    assert np.asarray(orbax_io.restore_params(path)["clip"]["logit_scale"]).shape == ()


def test_training_checkpoint_reads_bit_for_bit(tmp_path, jax_state):
    path = jorbax.save_checkpoint(str(tmp_path), 2, jax_state)
    tree = orbax_io.read_tree(path)
    assert_same_tree(tree, _jax_payload(jax_state, 2))
    assert isinstance(tree["opt_state_mu"]["clip"]["logit_scale"], torch.Tensor)
    assert tree["opt_state_mu"]["clip"]["logit_scale"].dtype == torch.bfloat16
    assert tree["step"].shape == () and int(tree["step"]) == 9 and int(tree["epoch"]) == 2
    assert_same_tree(orbax_io.restore_params(path), jax_state.params)
    # the root manifest names the data files of ocdbt.process_0/
    with ocdbt.OcdbtStore(path) as store:
        refs = [v for v in store._values.values() if isinstance(v, ocdbt.Ref)]
    assert refs and all(r.path.startswith("ocdbt.process_0/d/") for r in refs)


def test_every_zarr_dtype_reads_bit_for_bit(tmp_path):
    """<f4, <f2, bfloat16, <i4 and <i8 leaves, 0-d and not, as the JAX
    package's save_params writes them (numpy leaves keep their dtype)."""
    rng = np.random.default_rng(12)
    tree = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "f16": rng.standard_normal((7,)).astype(np.float16),
            "bf16": jnp.asarray(rng.standard_normal((2, 9)), jnp.bfloat16),
            "i32": rng.integers(-2**31, 2**31 - 1, (4, 2)).astype(np.int32),
            "i64": rng.integers(-2**62, 2**62, (6,)).astype(np.int64),
            "f16_0d": np.float16(1.5), "i64_0d": np.int64(-3)}
    path = jorbax.save_params(str(tmp_path), "dtypes", tree)
    with ocdbt.OcdbtStore(path) as store:
        dtypes = {k.split("/")[0]: json.loads(store[k])["dtype"] for k in store.keys()
                  if k.endswith(".zarray")}
    assert set(dtypes.values()) == {"<f4", "<f2", "bfloat16", "<i4", "<i8"}
    assert_same_tree(orbax_io.restore_params(path), tree)


MESH_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from segclip_tpu.checkpoint.orbax_io import save_params
assert len(jax.devices()) == 2, jax.devices()
mesh = Mesh(np.array(jax.devices()), ("x",))
rng = np.random.default_rng(11)
tree = {"rows": rng.standard_normal((64, 24)).astype(np.float32),
        "cols": rng.standard_normal((5, 32)).astype(np.float32),
        "cube": rng.standard_normal((4, 6, 8)).astype(np.float32),
        "half": rng.standard_normal((16, 8)).astype(np.float32),
        "ints": rng.integers(-9, 9, size=(10,)).astype(np.int32),
        "scalar": np.float32(2.5)}
specs = {"rows": P("x", None), "cols": P(None, "x"), "cube": P(None, "x", None),
         "half": P("x", None), "ints": P("x"), "scalar": P()}
placed = {k: jax.device_put(jnp.asarray(v, jnp.bfloat16 if k == "half" else None),
                            NamedSharding(mesh, specs[k])) for k, v in tree.items()}
save_params(sys.argv[1], "mesh", placed)
np.savez(sys.argv[2], **{k: np.asarray(v.astype(jnp.float32)) if k == "half"
                         else np.asarray(v) for k, v in placed.items()})
"""


def test_multi_chunk_arrays_from_a_two_device_mesh(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    subprocess.run([sys.executable, "-c", MESH_SCRIPT, str(tmp_path), str(tmp_path / "want.npz")],
                   check=True, env=env, timeout=300)
    got = orbax_io.restore_params(str(tmp_path / "mesh"))
    with np.load(tmp_path / "want.npz") as want:
        for k in want.files:
            g = got[k].float().numpy() if k == "half" else got[k]
            assert g.dtype == want[k].dtype and np.array_equal(g, want[k]), k
    assert got["half"].dtype == torch.bfloat16
    with ocdbt.OcdbtStore(str(tmp_path / "mesh")) as store:
        chunks = {k.split("/")[0].split(".", 1)[1]: json.loads(store[k])["chunks"]
                  for k in store.keys() if k.endswith(".zarray")}
        keys = store.keys()
    assert chunks["rows"] == [32, 24] and chunks["cols"] == [5, 16] and chunks["cube"] == [4, 3, 8]
    assert {"params.rows/0.0", "params.rows/1.0", "params.cols/0.1",
            "params.cube/0.1.0"} <= set(keys)


def test_directory_without_ocdbt_reads_bit_for_bit(tmp_path, jax_params):
    with ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)) as ckptr:
        ckptr.save(tmp_path / "plain", {"params": jax_params})
    with open(tmp_path / "plain" / "_METADATA") as f:
        assert json.load(f)["use_ocdbt"] is False
    assert not (tmp_path / "plain" / "manifest.ocdbt").exists()
    assert_same_tree(orbax_io.restore_params(str(tmp_path / "plain")), jax_params)


def test_zarr3_and_other_directories_are_refused(tmp_path, jax_params):
    path = jorbax.save_params(str(tmp_path), "p", {"w": jax_params["clip"]["logit_scale"]})
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump({**meta, "use_zarr3": True}, f)
    with pytest.raises(ValueError, match="use_zarr3"):
        orbax_io.read_tree(path)
    with pytest.raises(ValueError, match="not an Orbax directory"):
        orbax_io.read_tree(str(tmp_path))
    with pytest.raises(KeyError, match="opt_state_mu"):
        orbax_io.restore_checkpoint(jorbax.save_params(str(tmp_path), "q", jax_params),
                                    *_port_training(TRAIN_CFG))


# ---- the port writes, the JAX package reads ---------------------------------

@pytest.mark.parametrize("model_cfg", [TINY, dataclasses.replace(
    TINY, vision_width=128, transformer_width=128, use_text_mae_recon=False)],
    ids=["both_decoders", "width128_grouped_conv"])
def test_flax_state_dict_round_trip(model_cfg):
    """flax → the reference-layout state dict → flax, exact, for every leaf;
    at width 128 the grouped 1×1 convs have two groups."""
    _, params = jax_init_segclip(model_cfg, seed=5)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_state_dict(params, vision_patch_size=model_cfg.vision_patch_size).items()}
    assert_same_tree(flax_params_from_state_dict(sd), params)
    with pytest.raises(KeyError, match="no place"):
        flax_params_from_state_dict({**sd, "clip.visual.extra": torch.zeros(1)})


def _port_training(cfg, jparams=None):
    model = SegCLIP(port_config(cfg.model))
    if jparams is not None:
        assert load_into(model, state_dict_from_jax(jparams, cfg.model.vision_patch_size)) == []
    optimizer = create_optimizer(model, port_config(cfg), t_total=T_TOTAL)
    return model, optimizer, TrainState(step=0, seed=4)


def test_port_params_are_read_by_jax(tmp_path, jax_params):
    model = SegCLIP(port_config(TINY))
    load_into(model, state_dict_from_jax(jax_params, TINY.vision_patch_size))
    path = orbax_io.save_params(str(tmp_path), "params", model.state_dict())
    _, template = jax_init_segclip(TINY, seed=0)
    assert_same_tree(jorbax.restore_params(path, template), jax_params)
    assert_same_tree(orbax_io.restore_params(path), jax_params)
    with open(os.path.join(path, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is True


def test_port_checkpoint_is_read_by_jax_and_by_the_port(tmp_path, jax_params):
    """One port step (bf16 moments), saved by the port: the JAX package's
    restore_checkpoint gets the port's params, moments (zeros for the
    frozen parameters, as JAX keeps them), counters and epoch; the port's
    own restore gets every tensor back bit for bit."""
    from test_torch_train import make_batch, make_noise, torch_batch, torch_noise
    model, optimizer, state = _port_training(TRAIN_CFG, jax_params)
    step = make_train_step(model, optimizer, port_config(TRAIN_CFG))
    step(state, torch_batch(make_batch(3)), torch_noise(make_noise(4)))
    path = orbax_io.save_checkpoint(str(tmp_path), 3, model, optimizer, state)
    assert path == str(tmp_path / "ckpt_epoch_3")
    template, _, _ = create_train_state(TRAIN_CFG, jax_init_segclip(TINY, seed=0)[1],
                                        t_total=T_TOTAL, seed=4)
    restored, epoch = jorbax.restore_checkpoint(path, template)
    assert epoch == 3 and int(restored.step) == state.step == 1
    assert int(restored.opt_state.step) == optimizer.step_count == 1
    sd = model.state_dict()
    assert_same_tree(restored.params, flax_params_from_state_dict(sd))
    names = {p: n for n, p in model.named_parameters()}
    for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in sd.items()}
        want.update({names[p]: m[slot] for p, m in optimizer.state.items()})
        assert_same_tree(getattr(restored.opt_state, key), flax_params_from_state_dict(want))

    model2, optimizer2, fresh = _port_training(TRAIN_CFG)
    state2, epoch2 = orbax_io.restore_checkpoint(path, model2, optimizer2, fresh)
    assert (state2.step, state2.seed, epoch2, optimizer2.step_count) == (1, 4, 3, 1)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  model2.state_dict().values()))
    for p, p2 in zip(model.parameters(), model2.parameters()):
        assert (p in optimizer.state) == (p2 in optimizer2.state)
        for slot in optimizer.state.get(p, {}):
            assert optimizer2.state[p2][slot].dtype == torch.bfloat16
            assert torch.equal(optimizer.state[p][slot], optimizer2.state[p2][slot])


# ---- into the port ---------------------------------------------------------

def test_restore_checkpoint_maps_the_jax_state_into_the_port(tmp_path, jax_state):
    """A JAX checkpoint's params, moments (into exp_avg / exp_avg_sq in
    bfloat16, through the state-dict mapping), opt_step, step and epoch;
    the seed stays the caller's."""
    path = jorbax.save_checkpoint(str(tmp_path), 5, jax_state)
    model, optimizer, state = _port_training(TRAIN_CFG)
    state, epoch = orbax_io.restore_checkpoint(path, model, optimizer, state)
    assert (state.step, state.seed, epoch, optimizer.step_count) == (9, 4, 5, 7)
    host = jax.tree_util.tree_map(np.asarray, jax_state.params)
    want = state_dict_from_jax(host, TINY.vision_patch_size)
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in got) and got.keys() == want.keys()
    names = {p: n for n, p in model.named_parameters()}
    trainable = [p for g in optimizer.param_groups for p in g["params"]]
    assert len(optimizer.state) == len(trainable) < len(names)   # frozen ones hold none
    for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                         getattr(jax_state.opt_state, key))
        ref = state_dict_from_jax(moments, TINY.vision_patch_size)
        for p in trainable:
            m = optimizer.state[p][slot]
            assert m.dtype == torch.bfloat16 and torch.equal(m.float(), ref[names[p]])


def test_restore_checkpoint_slices_through_the_shard_hook(tmp_path, jax_state):
    """Under tensor parallelism the loop hands restore_checkpoint
    gspmd.shard_state_dict: it gets the full model and optimizer state
    dicts (the tp = 1 layout) and its slices are what is loaded."""
    path = jorbax.save_checkpoint(str(tmp_path), 0, jax_state)
    model, optimizer, state = _port_training(TRAIN_CFG)
    seen = []

    def shard(model_state, optimizer_state):
        seen.append((model_state, optimizer_state))
        cut = {k: v * 0 + 1 if k == "clip.logit_scale" else v for k, v in model_state.items()}
        return cut, optimizer_state
    orbax_io.restore_checkpoint(path, model, optimizer, state, shard=shard)
    (full, opt), = seen
    assert full.keys() == model.state_dict().keys()
    assert set(opt["state"]) == {i for g in opt["param_groups"] for i in g["params"]}
    assert float(model.clip.logit_scale) == 1.0
    assert float(full["clip.logit_scale"]) == float(np.asarray(
        jax_state.params["clip"]["logit_scale"]))


def test_restore_checkpoint_raises_on_a_leaf_or_parameter_the_other_lacks(tmp_path, jax_state):
    path = jorbax.save_checkpoint(str(tmp_path), 0, jax_state)
    deeper = dataclasses.replace(TRAIN_CFG, model=dataclasses.replace(TINY, vision_layers=5))
    with pytest.raises(KeyError, match="lacks"):
        orbax_io.restore_checkpoint(path, *_port_training(deeper))
    shallower = dataclasses.replace(TRAIN_CFG, model=dataclasses.replace(
        TINY, vision_layers=3, first_stage_layer=2))
    with pytest.raises(KeyError, match="does not have"):
        orbax_io.restore_checkpoint(path, *_port_training(shallower))


@pytest.mark.parametrize("kind", ["params", "training_checkpoint"])
def test_load_model_takes_an_orbax_directory(tmp_path, jax_state, kind):
    """--init-model <dir>: the same model as a model.pt of the same weights,
    the architecture inferred the same way; the decoder the configuration
    does not build is dropped."""
    if kind == "params":
        path = jorbax.save_params(str(tmp_path), "params", jax_state.params)
    else:
        path = jorbax.save_checkpoint(str(tmp_path), 0, jax_state)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_state.params),
                             TINY.vision_patch_size)
    torch.save(sd, tmp_path / "model.pt")
    base = dataclasses.replace(port_config(TINY), vision_layers=12, use_text_mae_recon=False)
    cpu = torch.device("cpu")
    got, cfg = load_model(path, base, cpu)
    want, want_cfg = load_model(str(tmp_path / "model.pt"), base, cpu)
    assert cfg == want_cfg and cfg.vision_layers == TINY.vision_layers and not got.training
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not any(k.startswith("seq_mae_decoder.") for k in a)


def test_train_resumes_from_an_orbax_checkpoint_bit_for_bit(tmp_path, corpus):  # noqa: F811
    """The loop's --do-resume from an Orbax ckpt_epoch_0 (the port's writer,
    from the torch checkpoint of the same state) takes the same epoch as
    the resume from the torch checkpoint: loss, every parameter and moment,
    both counters."""
    straight = str(tmp_path / "straight")
    result = tloop.train(tiny_config(corpus, straight, epochs=2), device="cpu")
    cfg = tiny_config(corpus, str(tmp_path / "orbax"), epochs=2)
    model = init_segclip(cfg.model)
    optimizer = create_optimizer(model, cfg, t_total=8)
    state, epoch = ckpt_io.restore_checkpoint(os.path.join(straight, "ckpt_epoch_0"), model,
                                              optimizer, TrainState(step=0, seed=cfg.train.seed))
    orbax_io.save_checkpoint(cfg.train.output_dir, epoch, model, optimizer, state)
    assert orbax_io.is_orbax_dir(os.path.join(cfg.train.output_dir, "ckpt_epoch_0"))
    assert orbax_io.auto_resume_path(cfg.train.output_dir).endswith("ckpt_epoch_0")
    resumed = tloop.train(cfg, resume=True, device="cpu")
    assert resumed["epochs_run"] == 1 and resumed["final_loss"] == result["final_loss"]
    assert [m["epoch"] for m in read_metrics(cfg.train.output_dir)] == [1] * 4
    a = torch.load(os.path.join(straight, "ckpt_epoch_1", "model.pt"), weights_only=True)
    b = torch.load(os.path.join(cfg.train.output_dir, "ckpt_epoch_1", "model.pt"),
                   weights_only=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = result["optimizer"].state_dict()["state"], resumed["optimizer"].state_dict()["state"]
    assert sa.keys() == sb.keys() and all(torch.equal(sa[i][m], sb[i][m])
                                          for i in sa for m in sa[i])
    assert resumed["optimizer"].step_count == result["optimizer"].step_count == 8
    assert resumed["state"].step == result["state"].step == 8


# ---- the committed fixture --------------------------------------------------

def test_fixture_arrays_have_their_recorded_sha256():
    with open(os.path.join(fixture_maker.FIXTURE_DIR, "fixture.json")) as f:
        meta = json.load(f)
    assert {name: chip_smoke.tree_sha256(orbax_io.read_tree(
        os.path.join(fixture_maker.FIXTURE_DIR, name))) for name in meta["sha256"]} == \
        meta["sha256"]
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
               os.walk(fixture_maker.FIXTURE_DIR) for f in fs)
    assert size < 4 * 2**20
    with ocdbt.OcdbtStore(os.path.join(fixture_maker.FIXTURE_DIR, "params")) as store:
        header = json.loads(store[meta["sharded"] + "/.zarray"])
    assert header["compressor"]["id"] == "zstd" and header["chunks"][0] * 2 == header["shape"][0]


def test_fixture_equals_a_fresh_generation(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, os.path.join(REPO, "tests", "make_orbax_fixture.py"),
                    str(tmp_path / "fresh")], check=True, env=env, timeout=600)
    old, new = fixture_maker.FIXTURE_DIR, str(tmp_path / "fresh")
    metas = []
    for root in (old, new):
        with open(os.path.join(root, "fixture.json")) as f:
            meta = json.load(f)
        meta.pop("versions")
        metas.append(meta)
    assert metas[0] == metas[1]
    with np.load(os.path.join(old, "fixture.npz")) as a, np.load(
            os.path.join(new, "fixture.npz")) as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    for name in ("params", "ckpt_epoch_1"):
        assert_same_tree(orbax_io.read_tree(os.path.join(new, name)),
                         orbax_io.read_tree(os.path.join(old, name)))


def test_fixture_requests_and_resumed_step_on_the_port():
    """chip_smoke.py's phase 15 (a) on the CPU: the float32 and bf16 whole
    requests from params/ against the JAX segmenter's logits and group map,
    and the float32 step from ckpt_epoch_1 against JAX's next-step loss."""
    out = chip_smoke.orbax_fixture_checks(torch.device("cpu"))
    assert out["f32"]["agree"] >= chip_smoke.E2E_MIN_AGREE
    assert out["f32"]["argmax_agree"] >= chip_smoke.E2E_MIN_AGREE
    assert out["f32"]["group_agree"] >= chip_smoke.E2E_MIN_AGREE
    assert out["bf16"]["agree"] >= chip_smoke.ORBAX_BF16_MIN_AGREE
    assert out["loss_rel"] <= chip_smoke.DRIFT_RTOL
    assert out["leaves"] == 93 + 282
