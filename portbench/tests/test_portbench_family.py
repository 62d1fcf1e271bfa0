"""The model family plugs into the BSP harness: the configuration's family
module is the only place that knows the model.  The dense decoder gives
exactly the values it gave before the interface (pinned literals), a
test-only family of two segments runs the reference without an edit to
any generic module, and the generic modules name no model."""

import ast
import hashlib
import re

import pytest
import torch

from portbench import counts, harness
from portbench.reference import bsp as ref
from portbench.tests import twokind
from portbench.tests.small import CELLS, small_cell

SEED = 2 ** 33 + 7

# the values at the cells' real shapes and at ``small(config)``, as the
# harness computed them before the family interface
FULL_BUCKETS = [(40960, 40960)] + [(225443840, 225443840)] * 3 + [
    (47208960, 47208960), (47190528, 47190528), (311164928, 311164928)]
FULL_LAYOUT = "5eeb0320ff0ee906d0dcafceafb40fef2b1390fcc5adefdd8ae7d6c3252a0cc2"
FULL_FLOPS = {"matmul": 53175990091776.0, "attention": 1031798784000.0,
              "total": 54207788875776.0}
SMALL_LAYOUT = "9803f9aa6de42956f6fe643ae456a0ac556fa6f260f25f534ea3099f9423114f"
SMALL_WEIGHTS = "1ffcbafad6015d5c2b0f19e86d22a24ebfee3571ce7ee8c881a12325bba926a9"
SMALL_LOSSES = {
    "qwen2.5-3b-10l.bsp-int8": [5.554312705993652, 5.555389404296875,
                                5.57988166809082],
    "qwen2.5-3b-10l.bsp-bf16": [5.554312705993652, 5.555473327636719,
                                5.579923629760742]}


def layout_digest(layout):
    h = hashlib.sha256()
    for b in layout.buckets:
        h.update(repr((b.index, b.raw, b.length, [
            (s.name, s.start, s.numel) for s in b.segments])).encode())
    h.update(repr(layout.rev).encode())
    return h.hexdigest()


def weights_digest(weights):
    h = hashlib.sha256()
    for n in sorted(weights):
        t = weights[n]
        h.update(repr((n, tuple(t.shape), str(t.dtype))).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_read_what_they_read_before(name):
    cell = harness.load_cell(name)
    model, t = ref.Model.of(cell.config), cell.traffic
    layout = ref.Layout(model, t["world"], t["bucket_mb"])
    assert [(b.raw, b.length) for b in layout.buckets] == FULL_BUCKETS
    assert layout_digest(layout) == FULL_LAYOUT
    assert model.family.train_flops(model.spec, t) == FULL_FLOPS

    cell = small_cell(name)
    model, t = ref.Model.of(cell.config), cell.traffic
    assert layout_digest(ref.Layout(model, t["world"], t["bucket_mb"])) \
        == SMALL_LAYOUT
    assert weights_digest(ref.make_weights(model, SEED, "cpu")) \
        == SMALL_WEIGHTS
    batches = ref.make_batches(model, t, SEED, 3, "cpu")
    assert ref.run(model, t, SEED, batches, "cpu").losses == \
        SMALL_LOSSES[name]


TWO = {"name": "twokind", "layers": 5, "width": 256, "ffn": 512,
       "vocab": 1000, "param_dtype": "float32"}


def _two_model():
    cfg = twokind.small(TWO)
    return ref.Model(twokind, twokind.spec(cfg))


def test_two_segments_stack_as_the_port_stacks_them():
    """The flat order of a leading layer and then layers of another kind
    equals the port's ``reference_leaves`` over a tree of those names."""
    from repro_torch.weights import reference_leaves
    model = _two_model()
    tree = {"layers": [{} for _ in range(model.spec.n_layers)]}
    for name, shape, _ in model.family.param_leaves(model.spec):
        parts = name.split("/")
        node = tree["layers"][int(parts[1])] if parts[0] == "layers" \
            else tree
        keys = parts[2:] if parts[0] == "layers" else parts
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(shape, device="meta")
    port = reference_leaves(tree, type("Cfg", (), {
        "segments": lambda self: (((("a",), 1), (("b",), 2)))})())
    mine = ref.stacked_leaves(model)
    assert [p for p, _ in mine] == [leaf.path.lstrip("/") for leaf in port]
    assert "segments/1/l0/ffn/w_gate/w" in dict(mine)
    assert dict(mine)["segments/1/l0/ffn/w_gate/w"] == [
        "layers/1/ffn/w_gate/w", "layers/2/ffn/w_gate/w"]
    assert dict(mine)["segments/0/l0/ffn/w_in/w"] == ["layers/0/ffn/w_in/w"]


def test_a_family_of_two_segments_runs_the_reference():
    """Layout, weights, the reference's first steps and the comparison on
    the test family, through the generic modules as they are."""
    model = _two_model()
    t = dict(harness.load_cell(CELLS[0]).traffic, seq_len=8,
             bucket_mb=0.004)
    layout = ref.Layout(model, t["world"], t["bucket_mb"])
    assert len(layout.buckets) > 1
    assert set(layout.where) == {
        n for n, _, _ in model.family.param_leaves(model.spec)}
    weights = ref.make_weights(model, SEED, "cpu")
    assert weights["layers/2/ffn/w_gate/w"].shape == (16, 32)
    assert "layers/0/ffn/w_gate/w" not in weights
    batches = ref.make_batches(model, t, SEED, 3, "cpu")
    same = ref.run(model, t, SEED, batches, "cpu")
    again = ref.run(model, t, SEED, batches, "cpu")
    assert all(v["value"] == 0 for v in ref.compare(again, same).values())
    half = ref.run(model, t, SEED, batches, "cpu", variant="half_batch")
    found = ref.compare(half, same)
    assert found["grad_gap"]["value"] > 0.05
    assert counts.error_feedback_bytes(layout) == 16 * t["world"] * sum(
        b.length for b in layout.buckets)


FAMILY_API = ("spec", "param_leaves", "segments", "loss", "train_flops",
              "small")
GENERIC = ["drivers/bsp_train.py", "reference/bsp.py", "counts.py",
           "tests/small.py"]
# what only a family may know: its name, the dense decoder's module and
# the Qwen2 configuration's keys
MODEL_WORDS = re.compile(
    r"qwen|\blm\b|intermediate_size|num_key_value_heads|hidden_size|"
    r"num_attention_heads|num_hidden_layers|vocab_size|tie_word_embeddings|"
    r"rope_theta|rms_norm_eps|ModelSpec", re.IGNORECASE)


@pytest.mark.parametrize("family", sorted(
    p.stem for p in (harness.HERE / "reference").glob("*.py")
    if p.stem not in ("__init__", "bsp", "lm")) + ["tests.twokind"])
def test_family_modules_provide_the_interface(family):
    import importlib
    mod = importlib.import_module(
        f"portbench.{family}" if "." in family
        else f"portbench.reference.{family}")
    assert all(callable(getattr(mod, f, None)) for f in FAMILY_API)


@pytest.mark.parametrize("path", GENERIC)
def test_generic_modules_name_no_model(path):
    text = (harness.HERE / path).read_text()
    assert not MODEL_WORDS.findall(text)


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax"), (path.name, n)
