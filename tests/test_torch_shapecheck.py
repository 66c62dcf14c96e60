"""The port's shapecheck family (``analysis/shapecheck.py``) on torch
fixtures: one case for each of the reference's ``test_shapecheck_*``
cases in ``test_fluidlint`` (``CASES``; each names its reference case),
asserting the same rule ids and finding keys; its registry held equal to
jitsan's and resolved against the port's tree; and
``infer_kernel_output`` held against the plain versions' real outputs on
the CPU at every ladder rung. Fixtures are parsed, never imported."""
import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.analysis import shapecheck
from fluidframework_tpu_torch.analysis.callgraph import build_callgraph
from fluidframework_tpu_torch.analysis.core import (
    DEFAULT_ROOTS,
    run_analysis,
    walk_python_files,
)
from fluidframework_tpu_torch.convert import batch_from_numpy
from fluidframework_tpu_torch.ops.bucket_ladder import BucketLadder
from fluidframework_tpu_torch.ops.host_bridge import noop_op, pack_rows
from fluidframework_tpu_torch.ops.segment_table import make_table
from fluidframework_tpu_torch.testing import jitsan

# the device roots and ladder sources the fixtures launch through
ROOTS = {
    "ops/merge_kernel.py": """
        def apply_window(table, batch):
            return table

        def apply_window_pingpong(dead, table, batch):
            return table

        def compact(table):
            return table
    """,
    "ops/merge_chunk.py": """
        def compile_chunks(arrays, k_max=8):
            return arrays

        def apply_window_chunked(table, chunked, K=8, steps=None):
            return table

        def apply_window_chunked_pingpong(dead, table, chunked, K=8,
                                          steps=None):
            return table
    """,
    "ops/segment_table.py": """
        def make_table(docs, capacity, device="cuda"):
            return docs
    """,
    "ops/host_bridge.py": """
        def pack_rows(n_rows, ops_by_row, bucket_floor=16):
            return ops_by_row
    """,
    "ops/bucket_ladder.py": """
        class BucketLadder:
            def __init__(self, window_floor=16, max_bucket=64):
                self.window_floor = window_floor

            def window_bucket(self, window):
                return window
    """,
}
PINGPONG = "from ops.merge_kernel import apply_window_pingpong as pingpong\n"
SERVE = """
    import torch

    from ops.bucket_ladder import BucketLadder
    from ops.merge_chunk import apply_window_chunked, compile_chunks
    from ops.merge_kernel import apply_window
    from ops.host_bridge import pack_rows

    WINDOW = 37
"""


def src(*parts) -> str:
    """A fixture module from dedented parts."""
    return "".join(textwrap.dedent(p) for p in parts)


# a device root calling into ops/k.py, where the kernel bodies live
KERNEL_ROOT = {"ops/merge_kernel.py": """
    from ops import k

    def apply_window(table, batch):
        return k.step(batch)
"""}


@dataclasses.dataclass
class Case:
    doc: str            # the reference case, then what it pins
    files: dict
    want: list          # [(rule, key)]
    message: str = ""
    also: tuple = ()    # (subdir, files, want) runs of the same rule

    @property
    def ref(self) -> str:
        return self.doc.split(":", 1)[0]


CASES = [
    Case("test_shapecheck_flags_read_after_donation: a name donated to a "
         "twin is read on a later path; tail calls and rebinding pass",
         {"ops/kern.py": src(PINGPONG, """
            def bad_dispatch(fodder, table, batch):
                out = pingpong(fodder, table, batch)
                return out, fodder.length

            def good_tail(fodder, table, batch):
                return pingpong(fodder, table, batch)

            def good_rotate(fodder, table, batch):
                fodder = pingpong(fodder, table, batch)
                return fodder.length
         """)},
         [("donated-buffer-reuse", "kern.py:bad_dispatch:fodder")],
         "read after being donated"),
    Case("test_shapecheck_flags_donating_the_live_input: one table "
         "passed donated and live in one launch",
         {"ops/kern.py": src(PINGPONG, """
            def serve(table, batch):
                return pingpong(table, table, batch)
         """)},
         [("donated-buffer-reuse", "kern.py:serve:table")],
         "both as a DONATED argument and as a live input"),
    Case("test_shapecheck_donation_propagates_through_wrappers: a wrapper "
         "forwarding a param into a twin donates it at its call sites",
         {"ops/wrap.py": src(PINGPONG, """
            def rotate(fodder, table, batch):
                return pingpong(fodder, table, batch)

            def serve(old, table, batch):
                out = rotate(old, table, batch)
                return out, old.count
         """)},
         [("donated-buffer-reuse", "wrap.py:serve:old")]),
    Case("test_shapecheck_donation_factory_and_fresh_constructor: a twin "
         "reached through its module donates too; a make_table result "
         "aliases nothing feeding it",
         {"ops/fact.py": """
            from ops import merge_chunk
            from ops.segment_table import make_table

            def serve(old, table, prog):
                out = merge_chunk.apply_window_chunked_pingpong(
                    old, table, prog, K=8)
                return out, old.count

            def fresh(table, prog):
                docs = 3
                out = merge_chunk.apply_window_chunked_pingpong(
                    make_table(docs, 64), table, prog, K=8)
                return out, docs
         """},
         [("donated-buffer-reuse", "fact.py:serve:old")]),
    Case("test_shapecheck_donation_sees_try_except_finally_paths: handler "
         "and finally bodies are post-launch paths",
         {"ops/kern.py": src(PINGPONG, """
            def log(x):
                return x

            def handler_read(fodder, table, batch):
                try:
                    out = pingpong(fodder, table, batch)
                    log(out)
                except ValueError:
                    return fodder.length
                return out

            def finally_read(fodder, table, batch):
                try:
                    return pingpong(fodder, table, batch)
                finally:
                    log(fodder.count)

            def handler_clean(fodder, table, batch):
                try:
                    return pingpong(fodder, table, batch)
                except ValueError:
                    return None
         """)},
         [("donated-buffer-reuse", "kern.py:finally_read:fodder"),
          ("donated-buffer-reuse", "kern.py:handler_read:fodder")]),
    Case("test_shapecheck_keyword_live_input_aliasing_flagged: the live "
         "input passed by keyword aliases the donated one",
         {"ops/kern.py": src(PINGPONG, """
            def serve(t, batch):
                return pingpong(t, table=t, batch=batch)
         """)},
         [("donated-buffer-reuse", "kern.py:serve:t")]),
    Case("test_shapecheck_donation_suppressible_inline: a deliberate trap "
         "read is suppressed on its line",
         {"ops/kern.py": src(PINGPONG, """
            def trap_test(fodder, table, batch):
                out = pingpong(fodder, table, batch)
                return out, fodder.length  # fluidlint: disable=donated-buffer-reuse -- deliberate trap read
         """)},
         []),
    Case("test_shapecheck_flags_unladdered_jit_shape: a launch shape not "
         "from the ladder on the serving path; a host trip count is no "
         "launch shape, and tests' paths are out of scope",
         {"ops/serve.py": src(SERVE, """
            def bad(table, ops):
                batch = torch.zeros(WINDOW)
                return apply_window(table, batch)

            def good_laddered(table, ops):
                ladder = BucketLadder(16, 64)
                batch = torch.zeros(ladder.window_bucket(len(ops)))
                return apply_window(table, batch)

            def good_trip_count(table, prog):
                return apply_window_chunked(table, prog, K=8, steps=WINDOW)
         """)},
         [("unladdered-jit-shape", "serve.py:bad:apply_window[1]")],
         "BucketLadder",
         also=(("elsewhere", "lib/serve.py", []),)),
    Case("test_shapecheck_flags_dtype_widen_in_jit_reachable_kernel: 64-bit "
         "casts, dtypes and implicit widens in a root-reachable helper; "
         "host-only code is out of scope",
         {**KERNEL_ROOT, "ops/k.py": """
            import torch

            def step(x):
                return _mix(x)

            def _mix(x):
                wide = x.to(torch.int64)
                acc = torch.zeros(4, dtype=torch.float64)
                weak = x.to(int)
                idx = x.long()
                total = x.sum() + torch.tensor(3)
                return wide + acc + weak + idx + total

            def host_only(x):
                return x.to(torch.int64)
         """},
         [("kernel-dtype-widen", f"k.py:_mix:{t}") for t in (
             "float64", "int", "int64", "long", "sum", "tensor")]),
    Case("test_shapecheck_plain_int_float_calls_are_not_widens: int() and "
         "float() are host scalars; int32 reductions, gather indices "
         "and a typed torch.tensor pass",
         {**KERNEL_ROOT, "ops/k.py": """
            import torch

            def step(x):
                n = int(4)
                scale = float(n)
                idx = x.clamp(min=0).long()
                s = x.sum(dtype=torch.int32) + torch.tensor(1, dtype=x.dtype)
                return x.gather(1, idx) * scale + s
         """},
         []),
    Case("test_shapecheck_dtype_widen_keys_distinguish_same_named_methods: "
         "two classes' same-named methods keep distinct keys",
         {"ops/merge_kernel.py": """
            from ops.k import A, B

            def apply_window(table, batch):
                return A.step(None, batch) + B.step(None, batch)
         """, "ops/k.py": """
            import torch

            class A:
                def step(self, x):
                    return x.to(torch.int64)

            class B:
                def step(self, x):
                    return x.to(torch.int64)
         """},
         [("kernel-dtype-widen", "k.py:A.step:int64"),
          ("kernel-dtype-widen", "k.py:B.step:int64")]),
    Case("test_shapecheck_flags_shape_mismatch: cat operands disagree off "
         "the joined axis; where branches do not broadcast",
         {**KERNEL_ROOT, "ops/k.py": """
            import torch

            def step(x):
                a = torch.zeros((4, 8), dtype=torch.int32)
                b = torch.ones((4, 9), dtype=torch.int32)
                cat = torch.cat([a, b], dim=0)
                ok = torch.cat([a, b], dim=1)
                sel = torch.where(x > 0, torch.zeros((4, 8)),
                                  torch.ones((4, 7)))
                return cat, ok, sel
         """},
         [("shape-mismatch", "k.py:step:cat:ax1:8v9"),
          ("shape-mismatch", "k.py:step:where:8v7")]),
    Case("test_shapecheck_concat_positional_axis: the dim arrives "
         "positionally; an unknown dim skips the per-axis check",
         {**KERNEL_ROOT, "ops/k.py": """
            import torch

            def step(k):
                a = torch.zeros(4, 8, dtype=torch.int32)
                b = torch.ones(4, 16, dtype=torch.int32)
                ok = torch.cat([a, b], 1)
                bad = torch.cat([a, b], 0)
                dyn = torch.cat([a, b], k)
                return ok, bad, dyn
         """},
         [("shape-mismatch", "k.py:step:cat:ax1:8v16")]),
    Case("test_shapecheck_fresh_constructor_exempts_only_its_subtree: a "
         "make_table in one branch does not absolve the other",
         {"ops/kern.py": src(PINGPONG, """
            from ops.segment_table import make_table

            def bad(fodder, table, batch, ok):
                out = pingpong(
                    fodder if ok else make_table(2, 64), table, batch)
                return out, fodder.count
         """)},
         [("donated-buffer-reuse", "kern.py:bad:fodder")]),
    Case("test_shapecheck_unladdered_keyword_shape_arg: a launch shape "
         "passed by keyword is checked too",
         {"ops/serve.py": src(SERVE, """
            def bad(table, ops):
                raw = torch.zeros(WINDOW)
                return apply_window(table, batch=raw)

            def good(table, ops):
                ladder = BucketLadder(16, 64)
                padded = torch.zeros(ladder.window_bucket(len(ops)))
                return apply_window(table, batch=padded)
         """)},
         [("unladdered-jit-shape", "serve.py:bad:apply_window[batch]")]),
    Case("test_shapecheck_static_argnames_exempt_keyword_args: a keyword "
         "outside the launch signature (steps=) is exempt, a laddered "
         "program passes",
         {"ops/serve.py": src(SERVE, """
            def good(table, ops, k):
                prog = compile_chunks(pack_rows(4, ops))
                return apply_window_chunked(table, prog, K=8, steps=k)
         """)},
         []),
    Case("test_shapecheck_rotate_in_loop_is_not_flagged: the rotate idiom "
         "in a loop passes; a read on the wrap-around path fires",
         {"ops/kern.py": src(PINGPONG, """
            def good_rotate(fodder, table, batches):
                for b in batches:
                    n = fodder.count
                    fodder = pingpong(fodder, table, b)
                return n

            def bad_wrap(fodder, table, batches):
                for b in batches:
                    n = fodder.count
                    out = pingpong(fodder, table, b)
                return n
         """)},
         [("donated-buffer-reuse", "kern.py:bad_wrap:fodder")]),
    Case("test_shapecheck_local_env_follows_statement_order: a later raw "
         "rebinding wins over an earlier laddered branch",
         {"ops/serve.py": src(SERVE, """
            def bad(table, ops, fast):
                if fast:
                    batch = torch.zeros(
                        BucketLadder(16, 64).window_bucket(len(ops)))
                batch = torch.zeros(WINDOW)
                return apply_window(table, batch)
         """)},
         [("unladdered-jit-shape", "serve.py:bad:apply_window[1]")]),
    Case("test_shapecheck_prewarm_coverage: a root the dispatch loop "
         "reaches and prewarm does not; walking it clears the finding, "
         "and a scan with no dispatch-loop module skips the rule",
         {"service/gpu_sidecar.py": """
            from ops.merge_kernel import apply_window, compact

            class GpuMergeSidecar:
                def _dispatch(self, x):
                    return self._apply_program(x)

                def _apply_program(self, x):
                    return compact(apply_window(x, x))

                def prewarm(self):
                    apply_window(0, 0)
         """},
         [("prewarm-coverage", "merge_kernel.py:compact")],
         "NOT from its BucketLadder prewarm",
         also=(("warm", "service/gpu_sidecar.py", []),
               ("leaf", None, []))),
]


def _lint(root, files):
    for relpath, source in files.items():
        path = root / relpath
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
    return run_analysis(roots=sorted({p.split("/")[0] for p in files}),
                        families=["shapecheck"], repo_root=str(root))


def _also(case, subdir, moved):
    """The case's tree for one of its extra runs: ``lib/serve.py`` moves
    the serving module out of the ladder's scope, ``warm`` walks the
    missing root in prewarm, ``leaf`` drops the dispatch-loop module."""
    files = dict(ROOTS)
    if moved == "lib/serve.py":
        files["lib/serve.py"] = case.files["ops/serve.py"]
    elif moved is not None:
        files[moved] = case.files[moved].replace(
            "apply_window(0, 0)", "compact(apply_window(0, 0))")
    return files


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.ref)
def test_shapecheck_case(case, tmp_path):
    """One reference case (``case.doc`` names it) on torch fixtures: the
    same rule ids and finding keys."""
    findings = _lint(tmp_path / "tree", {**ROOTS, **case.files})
    assert sorted((f.rule, f.key) for f in findings) == sorted(
        case.want), case.doc
    if case.message:
        assert case.message in findings[0].message
    for subdir, moved, want in case.also:
        got = _lint(tmp_path / subdir, _also(case, subdir, moved))
        assert [(f.rule, f.key) for f in got] == want, (case.doc, subdir)


def test_registry_is_jitsans():
    """``DEVICE_ROOTS`` is jitsan's ``_WRAPPED``: the same functions, the
    same root names and donated arguments; every launch-shape parameter
    and donated argument is a parameter of the function."""
    import importlib

    wrapped = {(m.replace(".", "/") + ".py", f): (root, donated)
               for (m, f), (root, _plain, _sig, donated)
               in jitsan._WRAPPED.items()}
    assert {k: v[:2] for k, v in shapecheck.DEVICE_ROOTS.items()} == wrapped
    for (path, name), (_root, donated, shape) in \
            shapecheck.DEVICE_ROOTS.items():
        module = importlib.import_module(
            "fluidframework_tpu_torch." + path[:-3].replace("/", "."))
        params = list(inspect.signature(
            getattr(module, name)).parameters)
        assert set(shape) <= set(params) and (
            donated is None or donated in params), (path, name)


def test_registries_name_port_code():
    """Every ladder source, laddered call site, dispatch and prewarm root
    and indirect edge names a function of the port's tree."""
    files = walk_python_files(DEFAULT_ROOTS)
    graph = build_callgraph(files)
    defs = {(info.relpath, info.qualname) for info in graph.functions()}

    def resolves(suffix, qual):
        return any(rel.endswith(suffix) and q == qual for rel, q in defs)

    named = list(shapecheck.LADDER_SOURCES)
    named += [(module, qual) for module, qual, _ in
              shapecheck.LADDERED_CALLS]
    for registry in (shapecheck.DISPATCH_ROOTS, shapecheck.PREWARM_ROOTS):
        named += [(s, q) for s, quals in registry.items() for q in quals]
    for caller, targets in shapecheck.PREWARM_INDIRECT.items():
        named += [caller, *targets]
    assert [n for n in named if not resolves(*n)] == []


# ---------------------------------------------------------------------------
# infer_kernel_output against the plain versions' real outputs


def _sig_of(tree) -> dict:
    items = zip(tree._fields, tree) if hasattr(tree, "_fields") \
        else tree.items()
    return {f: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for f, a in items if isinstance(a, torch.Tensor)}


def _batch(docs, bucket):
    return batch_from_numpy(pack_rows(docs, {0: [noop_op()]},
                                      bucket_floor=bucket), "cpu")


RUNGS = BucketLadder.capacity_rungs(32, 128)
BUCKETS = BucketLadder(16, 32).window_buckets()


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("bucket", BUCKETS)
def test_static_signatures_match_scan(rung, bucket):
    """The scan root and compact (the reference's
    ``test_static_signatures_match_eval_shape_scan``)."""
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window,
        compact,
    )

    table = make_table(4, rung, "cpu")
    spec = _sig_of(table)
    out = apply_window(table, _batch(4, bucket))
    assert shapecheck.infer_kernel_output("apply_window", spec) == \
        _sig_of(out)
    assert shapecheck.infer_kernel_output("compact", spec) == \
        _sig_of(compact(table))


@pytest.mark.parametrize("rung", RUNGS[:-1])
def test_static_signatures_match_pad_capacity(rung):
    from fluidframework_tpu_torch.ops.merge_kernel import pad_capacity

    table = make_table(4, rung, "cpu")
    assert shapecheck.infer_kernel_output(
        "pad_capacity", _sig_of(table), new_capacity=rung * 2) == \
        _sig_of(pad_capacity(table, rung * 2))


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("route", ["chunked", "egwalker"])
def test_static_signatures_match_macro_routes(rung, route):
    """The chunked and egwalker roots (the reference's ``..._chunked``
    and ``..._egwalker`` cases) at every rung and bucket."""
    from fluidframework_tpu_torch.convert import program_to_device
    from fluidframework_tpu_torch.ops import event_graph, merge_chunk

    for bucket in BUCKETS:
        table = make_table(4, rung, "cpu")
        arrays = pack_rows(4, {0: [noop_op()]}, bucket_floor=bucket)
        if route == "chunked":
            prog = merge_chunk.compile_chunks(arrays)
            out = merge_chunk.apply_window_chunked(
                table, program_to_device(prog, "cpu"),
                steps=merge_chunk.macro_steps(prog["chunk_start"],
                                              merge_chunk.CHUNK_K))
        else:
            prefix = event_graph.build_event_graph(arrays)["prefix"]
            out = event_graph.apply_window_egwalker(
                table, program_to_device(prefix, "cpu"),
                steps=merge_chunk.macro_steps(prefix["chunk_start"],
                                              event_graph.EG_K))
        assert shapecheck.infer_kernel_output(route, _sig_of(table)) == \
            _sig_of(out), bucket


@pytest.mark.parametrize("rung", RUNGS)
def test_static_signatures_match_seq_shard(rung):
    from fluidframework_tpu_torch.parallel.seq_shard import (
        apply_window_seq_sharded,
        make_seq_mesh,
    )

    table = make_table(4, rung, "cpu")
    out = apply_window_seq_sharded(
        table, _batch(4, 16), make_seq_mesh([torch.device("cpu")] * 2))
    assert shapecheck.infer_kernel_output("seq_shard", _sig_of(table)) == \
        _sig_of(out)


@pytest.mark.parametrize("rung", (128, 256))
def test_static_signatures_match_window_kernel_plain(rung):
    """B1's plain version (the reference's ``..._pallas`` case: the window
    kernel the CUDA build replaces) under the ``apply_window`` root."""
    from fluidframework_tpu_torch.ops.merge_kernel import apply_window_plain

    table = make_table(8, rung, "cpu")
    out = apply_window_plain(table, _batch(8, 16))
    assert shapecheck.infer_kernel_output("apply_window", _sig_of(table)) \
        == _sig_of(out)


def test_static_signatures_match_tree_roots():
    """The tree window and its pad step (port roots the reference's
    cases do not cover)."""
    from fluidframework_tpu_torch.ops.tree_apply import (
        DEFAULT_ATOMS,
        make_tree_table,
        pad_tree_capacity,
    )
    from fluidframework_tpu_torch.service.tree_sidecar import _warm_dispatch

    for rung in (32, 64):
        table = make_tree_table(4, rung, "cpu")
        spec = _sig_of(table)
        for route in ("atom", "macro"):
            out = _warm_dispatch(4, BucketLadder(), DEFAULT_ATOMS,
                                 "cpu").apply(
                table, route)
            assert shapecheck.infer_kernel_output("tree_window", spec) == \
                _sig_of(out)
        assert shapecheck.infer_kernel_output(
            "tree_pad", spec, new_capacity=rung * 2) == \
            _sig_of(pad_tree_capacity(table, rung * 2))
        assert np.array_equal(table.count.numpy(), np.zeros(4))


def test_infer_kernel_output_rejects_unknown_root():
    with pytest.raises(ValueError, match="unknown kernel root"):
        shapecheck.infer_kernel_output("warp_drive", {})
    with pytest.raises(ValueError, match="new_capacity"):
        shapecheck.infer_kernel_output("pad_capacity", {})
