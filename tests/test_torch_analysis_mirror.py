"""The reference's fluidlint tests (``test_fluidlint``,
``test_fluidlint_gate``, ``test_layer_check``, ``test_wirecheck``,
``test_failcheck``), run on the port's ``analysis`` package
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired).

A case that builds its own fixture tree runs on both packages. A case
that reads the real tree (the gate's whole-tree run, a package walk, the
CLI over the default roots) runs on the port only: the reference's own
files run it on the reference, and a second whole-tree run of the
reference here would only add to the reference gate's timed wall. The
port's whole-tree run happens once per process (the mirrored source's
memoized ``_gate()``).

Three cases run with edits (``BY_HAND_EDITS``), on the port only. Two
enumerate the families: the port has ``synccheck`` where the reference
has ``jaxhazards``, and its shapecheck fixture is torch code. The third
plants its dispatch loop in the reference's sidecar module, which the
port's ``DISPATCH_LOOPS`` names ``service/gpu_sidecar.py``. The
jaxhazards cases are left out (``LEFT_OUT``): its dispatch-loop rule is
the port's synccheck (``tests/test_torch_synccheck.py``), and its
``jit-*`` rules guard a traced program the port does not have. The
shapecheck fixture cases are jax programs: ``tests/test_torch_shapecheck
.py`` holds a torch counterpart of each; its two gate cases run here.
"""
import ast

import pytest

from test_torch_service_layers import (
    PACKAGES,
    TESTS,
    case_id,
    mirror_cases,
    run_mirrored,
)

PORT = PACKAGES[1]
MIRRORED = ("test_fluidlint", "test_fluidlint_gate", "test_layer_check",
            "test_wirecheck", "test_failcheck")

_JAX = ("jaxhazards reasons about jax.jit: its dispatch-loop-sync rule "
        "is the port's synccheck (tests/test_torch_synccheck.py), and its "
        "jit-* rules (a frozen clock read, a host callback, a branch on a "
        "tracer, unhashable static arguments) guard a traced program the "
        "port does not have")
_SHAPE = ("the fixture is a jax.jit program: tests/test_torch_shapecheck.py "
          "holds its torch counterpart (CASES names it)")
LEFT_OUT = {
    "test_fluidlint": {
        **{name: _JAX for name in (
            "test_jaxhazards_flags_nondeterminism_reached_through_helper",
            "test_jaxhazards_flags_uuid_and_numpy_random",
            "test_jaxhazards_flags_tracer_branch_and_host_callback",
            "test_jaxhazards_tracks_keyword_only_params",
            "test_jaxhazards_flags_unhashable_static_default",
            "test_jaxhazards_follows_jitted_lambda_without_param_misfire",
            "test_jaxhazards_clean_on_idiomatic_kernel",
            "test_jaxhazards_flags_sync_inside_dispatch_loop",
            "test_jaxhazards_dispatch_loop_clean_when_sync_stays_in_boundary",
            "test_jaxhazards_flags_cross_module_hazard_via_callgraph",
            "test_jaxhazards_cross_module_does_not_double_report",
        )},
        **{name: _SHAPE for name in (
            "test_shapecheck_flags_read_after_donation",
            "test_shapecheck_flags_donating_the_live_input",
            "test_shapecheck_donation_propagates_through_wrappers",
            "test_shapecheck_donation_factory_and_fresh_constructor",
            "test_shapecheck_donation_sees_try_except_finally_paths",
            "test_shapecheck_keyword_live_input_aliasing_flagged",
            "test_shapecheck_donation_suppressible_inline",
            "test_shapecheck_flags_unladdered_jit_shape",
            "test_shapecheck_flags_dtype_widen_in_jit_reachable_kernel",
            "test_shapecheck_plain_int_float_calls_are_not_widens",
            "test_shapecheck_dtype_widen_keys_distinguish_same_named_methods",
            "test_shapecheck_flags_shape_mismatch",
            "test_shapecheck_concat_positional_axis",
            "test_shapecheck_fresh_constructor_exempts_only_its_subtree",
            "test_shapecheck_unladdered_keyword_shape_arg",
            "test_shapecheck_static_argnames_exempt_keyword_args",
            "test_shapecheck_rotate_in_loop_is_not_flagged",
            "test_shapecheck_local_env_follows_statement_order",
            "test_shapecheck_prewarm_coverage",
        )},
    },
    "test_fluidlint_gate": {
        "test_bench_records_carry_fluidlint_counts":
            "bench.py is the reference's benchmark and counts the "
            "reference's families only; the port has no bench entry "
            "yet (ROADMAP.md queue A, item A5)",
    },
}

# the cases that read the real tree: the port only
PORT_ONLY = {
    ("test_layer_check", "test_no_undeclared_cross_package_imports"),
    ("test_layer_check", "test_every_subpackage_is_declared"),
    *(("test_fluidlint_gate", name) for name in (
        "test_fluidlint_gate_is_clean",
        "test_canonical_hops_resolve_to_live_stamp_sites",
        "test_undocumented_metric_live_tree_is_clean",
        "test_fence_before_fanout_live_tree_is_clean",
        "test_retry_without_jitter_live_tree_is_clean",
        "test_unbounded_blocking_wait_live_tree_is_clean",
        "test_detcheck_live_tree_is_clean_with_empty_allowlist",
        "test_wirecheck_live_tree_is_clean_with_empty_allowlist",
        "test_wire_schema_registry_resolves_to_live_traffic",
        "test_failcheck_live_tree_is_clean_with_empty_allowlist",
        "test_silent_handlers_registry_resolves_to_live_sites",
        "test_wall_clock_sinks_registry_resolves_to_live_sites",
        "test_concheck_live_tree_is_clean_within_the_ratchet",
        "test_shapecheck_family_is_in_the_gate",
        "test_shapecheck_live_tree_is_clean_within_the_ratchet",
        "test_combined_gate_run_stays_under_budget",
        "test_cli_json_mode_exits_zero_on_clean_tree",
    )),
}

# the cases run with the port's edits: two enumerate the families (the
# port's shapecheck fixture is torch code)
_FIXTURE_SIDECAR = '''        "fluidframework_tpu_torch/service/tpu_sidecar.py": """
            class Sidecar:
                def _dispatch(self, ops):
                    try:
                        self._run(ops)'''
BY_HAND_EDITS = {
    ("test_fluidlint",
     "test_finding_keys_are_line_free_across_all_families"): (
        ('''        "src/kernel.py": """
            import time

            import jax

            @jax.jit
            def step(x):
                return x * time.time()
        """,
''', ""),
        ('''        "fluidframework_tpu_torch/ops/hotk.py": """
            import jax
            import jax.numpy as jnp

            def impl(dead, batch):
                return batch.astype(jnp.int64)

            pingpong = jax.jit(impl, donate_argnums=(0,))

            RAW = 37

            def dispatch(fodder, batch):
                out = pingpong(fodder, batch)
                return out, fodder.count

            def unladdered(batch):
                bad = jnp.zeros(RAW)
                return pingpong(bad, batch)
        """,
''', '''        "fluidframework_tpu_torch/ops/merge_kernel.py": """
            import torch

            def apply_window_pingpong(dead, table, batch):
                return batch.long()

            RAW = 37

            def dispatch(fodder, table, batch):
                out = apply_window_pingpong(fodder, table, batch)
                return out, fodder.count

            def unladdered(table, batch):
                bad = torch.zeros(RAW)
                return apply_window_pingpong(bad, table, batch)
        """,
'''),
        # the port's dispatch loop module, with a synccheck hit in it
        (_FIXTURE_SIDECAR, _FIXTURE_SIDECAR.replace(
            "tpu_sidecar.py", "gpu_sidecar.py").replace(
            "self._run(ops)", "self._run(ops).cpu()")),
        ('''    key_families = ["layercheck", "jaxhazards", "lockcheck",
                    "qoscheck", "concheck", "shapecheck", "detcheck",
                    "wirecheck", "failcheck"]''',
         '''    key_families = ["layercheck", "synccheck", "lockcheck",
                    "qoscheck", "concheck", "shapecheck", "detcheck",
                    "wirecheck", "failcheck"]'''),
        ('''    assert {"donated-buffer-reuse", "unladdered-jit-shape",
            "kernel-dtype-widen"} <= _rules(baseline)''',
         '''    assert {"donated-buffer-reuse", "unladdered-jit-shape",
            "kernel-dtype-widen",
            "dispatch-loop-sync"} <= _rules(baseline)'''),
        ('''        "tpu_sidecar.py:Sidecar.recv:except-OSError",
        "tpu_sidecar.py:Sidecar.recv:except-OSError2",''',
         '''        "gpu_sidecar.py:Sidecar.recv:except-OSError",
        "gpu_sidecar.py:Sidecar.recv:except-OSError2",'''),
    ),
    # the fixture names the reference's dispatch-loop module
    ("test_failcheck", "test_broad_except_in_dispatch_loop_rule"): (
        ("tpu_sidecar.py", "gpu_sidecar.py"),
    ),
    ("test_fluidlint_gate", "test_family_rules_map_stays_complete"): (
        ('''    for rule in ("layer-undeclared", "jit-nondeterminism",''',
         '''    for rule in ("layer-undeclared",'''),
    ),
}


def _cases() -> list:
    out = []
    for case in mirror_cases(MIRRORED, LEFT_OUT):
        module, name, params = getattr(case, "values", case)
        marks = getattr(case, "marks", ())
        for package in PACKAGES:
            if package != PORT and (module, name) in PORT_ONLY:
                continue
            if package != PORT and (module, name) in BY_HAND_EDITS:
                continue
            out.append(pytest.param(
                package, module, name, params, marks=marks,
                id=f"{package}-{module}-{name}-{case_id(params)}"))
    return out


@pytest.mark.parametrize("package,module,name,params", _cases())
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params,
                 BY_HAND_EDITS.get((module, name), ()))


def test_left_out_cases_exist():
    """Every case named as left out, port-only or edited is still a
    test of the reference."""
    for module in MIRRORED:
        tree = ast.parse((TESTS / f"{module}.py").read_text())
        defined = {n.name for n in tree.body
                   if isinstance(n, ast.FunctionDef)}
        named = set(LEFT_OUT.get(module, {})) | {
            n for m, n in (*PORT_ONLY, *BY_HAND_EDITS) if m == module}
        assert named <= defined, (module, named - defined)


def test_shapecheck_cases_have_torch_counterparts():
    """Every reference shapecheck fixture case left out here has its
    torch counterpart in ``tests/test_torch_shapecheck.py``, and that
    file holds no case of a name the reference lacks."""
    from test_torch_shapecheck import CASES

    shape = {n for n, why in LEFT_OUT["test_fluidlint"].items()
             if why == _SHAPE}
    assert len(shape) == 19
    assert sorted(c.ref for c in CASES) == sorted(shape)
