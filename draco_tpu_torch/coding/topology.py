"""The tree topology (draco_tpu/coding/topology.py): the hierarchical
CodedReduce aggregation on one card.

The (n,) worker axis is partitioned into G = n / g leaf groups of fan-in g
(worker i in group i // g); every group runs the same small code over its
own g batch rows, decodes locally, and the decoded (d,) partials combine
level by level to Σ_all / n, the flat decode's convention. Per-group code
strength: ``s_g = min(worker_fail, (g - 1) // 4)`` (the small cyclic code
needs g > 4·s_g). The per-group health folds to one verdict a step as the
segments' do: residual the worst group's, flagged and loud the groups'
masks concatenated back to (n,), honest concatenated.

The plan algebra (``TOPOLOGIES`` … ``tree_ledger_block``) is the
reference's, copied. The device layout is not: on one card the groups are
a tensor axis, as the workers are, and since every group shares one small
code the tree maps onto the flat kernels with per-group coefficients, at
one launch each where the reference loops over the G groups:

  encode      the small code's ``complex_matmul`` a group, each writing its
              rows of the (n, d) pair in place (one launch of the
              block-diagonal (n, n) W was slower on the H100: 0.9813 ms
              against 0.8133 for the two at n=16, d=11,173,962, PERF.md
              §6); the approx code's block-diagonal weights in one matrix
              product
  project     one ``complex_project`` over all n rows: group j's projected
              column is rows [j·g, (j+1)·g) of it, reshaped to (G, g)
  locate      one ``cyclic_locator`` over L = G columns at n = g, s = s_g,
              each column with its own group's presence (``(L, g)``); on
              the segmented wire S·G columns
  recombine   one ``complex_recombine`` (``cyclic_narrow_recombine`` on a
              narrow wire, the segment forms on the segmented wire) over
              all n rows with the folded vector: each group's v, which the
              small code scales by 1/g, divided by G, i.e. v / n — equal to
              ``combine_partials`` of the group partials up to f32
              summation order

The approx tree: each group's host solve at n = g with its presence, the
decode one ``approx_decode`` launch with the concatenated weights v / n,
so the residual is the root's against the full true mean, as the
reference measures it; the bound √Σ bound_j², the recovered fraction the
mean over the groups.

The reference's mesh form (``tree_axis_names``, ``tree_mesh``,
``make_tree_decode_shmap``, ``lint_programs``) lays the combine levels on
TPU mesh axes; one card has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

TOPOLOGIES = ("flat", "tree")

# partial-combine wire width: parents ingest decoded f32 (d,) partials
PARTIAL_BYTES = 4


# --------------------------------------------------------------------------
# the plan algebra (the reference's, copied)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreePlan:
    """The static tree shape: who groups with whom, and how groups fold."""

    n: int
    fanout: int
    levels: int  # total levels including the leaf level (>= 2)
    num_groups: int
    # combine fan-ins, innermost (level 1, adjacent groups) first; their
    # product is num_groups and each is <= fanout
    level_fanouts: Tuple[int, ...]
    # leaf group j = workers [group_slices[j][0], group_slices[j][1])
    group_slices: Tuple[Tuple[int, int], ...]

    @property
    def level_widths(self) -> Tuple[int, ...]:
        """Node count per level, leaves first: (G, G/f1, ..., 1)."""
        widths = [self.num_groups]
        for f in self.level_fanouts:
            widths.append(widths[-1] // f)
        return tuple(widths)


def auto_levels(n: int, fanout: int) -> int:
    """Leaf level + enough combine levels of fan-in <= ``fanout`` to fold
    G = n/fanout groups to one root: ``1 + ceil(log_g(G))`` (min 2)."""
    groups = n // fanout
    return 1 + max(1, math.ceil(math.log(groups, fanout))) if groups > 1 \
        else 2


def level_fanouts(num_groups: int, fanout: int,
                  levels: int) -> Tuple[int, ...]:
    """Split the group-folding into ``levels - 1`` per-level fan-ins, each
    <= ``fanout``, innermost first, product exactly ``num_groups``."""
    fans = []
    remaining = num_groups
    for _ in range(levels - 1):
        f = min(fanout, remaining)
        fans.append(max(f, 1))
        remaining = -(-remaining // max(f, 1))
    if math.prod(fans) != num_groups:
        raise ValueError(
            f"tree_levels={levels} cannot fold {num_groups} groups with "
            f"fan-in <= {fanout} (per-level fan-ins {fans} multiply to "
            f"{math.prod(fans)})")
    return tuple(fans)


def tree_plan(n: int, fanout: int, levels: int = 0) -> TreePlan:
    """Validated tree shape for ``n`` workers at fan-in ``fanout``.
    ``levels=0`` auto-derives ``auto_levels``."""
    n, fanout = int(n), int(fanout)
    if fanout < 2:
        raise ValueError(f"tree_fanout must be >= 2, got {fanout}")
    if n % fanout != 0:
        raise ValueError(
            f"topology='tree' needs num_workers % tree_fanout == 0, got "
            f"n={n}, g={fanout}")
    groups = n // fanout
    if groups < 2:
        raise ValueError(
            f"topology='tree' needs at least 2 leaf groups (n > fanout), "
            f"got n={n}, g={fanout} — use topology='flat'")
    lv = int(levels) or auto_levels(n, fanout)
    if lv < 2:
        raise ValueError(f"tree_levels must be >= 2 (or 0 = auto), got {lv}")
    fans = level_fanouts(groups, fanout, lv)
    slices = tuple((j * fanout, (j + 1) * fanout) for j in range(groups))
    return TreePlan(n=n, fanout=fanout, levels=lv, num_groups=groups,
                    level_fanouts=fans, group_slices=slices)


def group_worker_fail(fanout: int, worker_fail: int) -> int:
    """The per-group cyclic error budget: the flat ``s`` capped by the small
    code's existence bound g > 4·s_g."""
    return min(int(worker_fail), max((int(fanout) - 1) // 4, 0))


def tree_ledger_block(n: int, fanout: int, levels: int, dim: int,
                      physical_bytes_per_worker: int) -> dict:
    """Per-level ingest bytes a step. Level 0 is the leaf ingest — each
    leaf node receives its g workers' codewords, and the per-group bytes
    sum exactly to the flat bytes a step; combine level l >= 1 ingests its
    children's decoded f32 (d,) partials: ``level_widths[l-1] · 4 · dim``
    bytes a step, constant a node (fan-in · 4 · dim) as n grows."""
    plan = tree_plan(n, fanout, levels)
    leaf_group = fanout * int(physical_bytes_per_worker)
    widths = plan.level_widths
    level_bytes = [leaf_group * plan.num_groups]
    level_bytes += [widths[lv - 1] * PARTIAL_BYTES * int(dim)
                    for lv in range(1, plan.levels)]
    return {
        "fanout": plan.fanout,
        "levels": plan.levels,
        "num_groups": plan.num_groups,
        "level_fanouts": list(plan.level_fanouts),
        "level_widths": list(widths),
        "ingest_bytes_per_group": leaf_group,
        # per-node ingest at each level: what one aggregation point pays
        "node_ingest_bytes": [leaf_group] + [
            f * PARTIAL_BYTES * int(dim) for f in plan.level_fanouts],
        "level_bytes_per_step": level_bytes,
    }


# --------------------------------------------------------------------------
# tree codes on the card
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeCode:
    """One small per-group code and the plan that tiles it over the fleet:
    the groups are equal and share the code's constants."""

    plan: TreePlan
    group_code: object  # CyclicCode(g, s_g) or ApproxCode(g, r, scheme)
    family: str  # "cyclic" | "approx"

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def s(self) -> int:
        """Per-group error budget (cyclic); 0 for approx."""
        return getattr(self.group_code, "s", 0)

    @property
    def groups(self) -> int:
        return self.plan.num_groups

    @property
    def fanout(self) -> int:
        return self.plan.fanout

    def weights_on(self, device) -> torch.Tensor:
        """The approx tree's (n, n) block-diagonal encode weights on
        ``device`` (cached per device), each block the group code's."""
        cache = self.__dict__.setdefault("_weights", {})
        key = str(device)
        if key not in cache:
            cache[key] = torch.block_diag(
                *[self.group_code.weights_on(device)] * self.groups)
        return cache[key]


def build_tree_code(cfg) -> TreeCode:
    """The tree code a config names: cyclic groups at ``s_g =
    group_worker_fail`` or approx groups at the configured fractional
    redundancy (``config.validate`` has checked the shape)."""
    from draco_tpu_torch.coding import approx as approx_mod
    from draco_tpu_torch.coding import cyclic as cyclic_mod

    plan = tree_plan(cfg.num_workers, cfg.tree_fanout, cfg.tree_levels)
    if cfg.approach == "cyclic":
        s_g = group_worker_fail(cfg.tree_fanout, cfg.worker_fail)
        return TreeCode(plan, cyclic_mod.build_cyclic_code(plan.fanout, s_g),
                        "cyclic")
    if cfg.approach == "approx":
        return TreeCode(plan, approx_mod.build_approx_code(
            plan.fanout, cfg.code_redundancy, cfg.assignment_scheme),
            "approx")
    raise ValueError(
        f"topology='tree' supports cyclic/approx, got {cfg.approach!r} "
        "(maj_vote's repetition groups are already a one-level tree)")


def is_tree(code) -> bool:
    return isinstance(code, TreeCode)


def combine_partials(plan: TreePlan, parts: torch.Tensor) -> torch.Tensor:
    """Level-structured combine of the (G, d) group partials: each combine
    level sums its fan-in children (adjacent groups first), the root
    divides by G — numerically the mean of the groups = Σ_all / n."""
    x = parts
    for f in plan.level_fanouts:
        x = x.reshape(-1, f, x.shape[-1]).sum(dim=1)
    return x[0] / plan.num_groups


def encode_tree(tcode: TreeCode, batch_grads: torch.Tensor):
    """The tree encode of the one-copy batch gradients (n, d): rows [lo,
    hi) are the small code's encode of that group's batch rows. Returns
    the cyclic (enc_re, enc_im) pair (a ``complex_matmul`` a group, into
    its rows) or the approx (n, d) partial sums (one matrix product of the
    block-diagonal weights)."""
    from draco_tpu_torch.ops import coded as ops_coded

    if tcode.family != "cyclic":
        return tcode.weights_on(batch_grads.device) @ batch_grads
    t = tcode.group_code.tensors(batch_grads.device)
    enc_re = torch.empty_like(batch_grads)
    enc_im = torch.empty_like(batch_grads)
    for lo, hi in tcode.plan.group_slices:
        ops_coded.complex_matmul(t["w_masked_re"], t["w_masked_im"],
                                 batch_grads[lo:hi],
                                 out=(enc_re[lo:hi], enc_im[lo:hi]))
    return enc_re, enc_im


def _group_presence(tcode: TreeCode, present, columns: int,
                    device) -> torch.Tensor:
    """The locator's presence for ``columns`` stacked group columns (a
    multiple of G, segment-major): (1, g) ones with every row present,
    else each column's own group's (columns, g) f32 presence."""
    g, G = tcode.fanout, tcode.groups
    if present is None:
        return torch.ones((1, g), dtype=torch.float32, device=device)
    pres = present.to(torch.float32).reshape(G, g)
    return pres.repeat(columns // G, 1).contiguous()


def decode_tree_cyclic(tcode: TreeCode, r_re: torch.Tensor,
                       r_im: torch.Tensor, rand_factor: torch.Tensor,
                       present: Optional[torch.Tensor] = None,
                       rel_tol: Optional[float] = None, lam: float = 0.0,
                       wire=None, bounds=None):
    """The tree's cyclic decode on the (n, d) received rows: every group's
    small decode at once (module docstring), whole-d or, when ``bounds``
    has interior cuts, over the segmented wire's segments, each group's
    segments folded. ``wire``: the narrow wire of the n rows, which the
    recombination reads in place of the widened rows.

    Returns ``(decoded (d,), honest (n,), health)``: ``residual`` the worst
    group's (and segment's), ``flagged`` and ``loud`` (n,) — the flat
    decode's contract."""
    from draco_tpu_torch.coding import cyclic as cyclic_mod
    from draco_tpu_torch.ops import coded as ops_coded
    from draco_tpu_torch.ops import decode_kernels

    code, n = tcode.group_code, tcode.n
    G, g = tcode.groups, tcode.fanout
    if rel_tol is None:
        rel_tol = cyclic_mod.HEALTH_REL_TOL
    narrow = decode_kernels.narrow_kernel_ok(wire)
    if bounds is not None and len(bounds) > 2:
        plan = ops_coded.segment_plan(bounds, r_re.device)
        e_re, e_im = ops_coded.complex_project_segments(r_re, r_im,
                                                        rand_factor, plan)
        segs = e_re.shape[0]
    else:
        plan = None
        e_re, e_im = ops_coded.complex_project(r_re, r_im, rand_factor)
        segs = 1
    cols = segs * G
    pres_f = _group_presence(tcode, present, cols, r_re.device)
    v_re, v_im, honest_l, flagged_l, loud_l, resid_l = (
        decode_kernels.cyclic_locator(code, e_re.reshape(cols, g),
                                      e_im.reshape(cols, g), pres_f,
                                      rel_tol, lam=lam))
    # the folded vector: the small code's v / g, over G groups
    v_re, v_im = v_re.reshape(segs, n) / n, v_im.reshape(segs, n) / n
    if plan is None:
        if narrow:
            decoded = decode_kernels.cyclic_narrow_recombine(v_re[0],
                                                             v_im[0], wire)
        else:
            decoded = ops_coded.complex_recombine(v_re[0], v_im[0], r_re,
                                                  r_im)
    elif narrow:
        decoded = decode_kernels.cyclic_narrow_recombine_segments(
            v_re, v_im, wire, plan)
    else:
        decoded = ops_coded.complex_recombine_segments(v_re, v_im, r_re,
                                                       r_im, plan)
    honest = honest_l.reshape(segs, n).all(dim=0)
    health = {"residual": resid_l.max(),
              "flagged": flagged_l.reshape(segs, n).any(dim=0),
              "loud": loud_l.reshape(segs, n).any(dim=0)}
    return decoded, honest, health


def host_solve(tcode: TreeCode, present=None):
    """The approx tree's host half: each group's optimal-decoding solve at
    n = g with its own presence. Returns ``(v (n,), vn_pres (2, n),
    host)`` as ``coding.approx.host_solve`` does: ``vn_pres`` = [v / n,
    presence] (each group's v / g over G), ``host`` the folded ``bound``
    (√Σ bound_j²) and ``recovered_fraction`` (the mean over the groups)."""
    from draco_tpu_torch.coding import approx as approx_mod

    code = tcode.group_code
    pres = approx_mod.presence(tcode, present)
    vs, bounds_sq, rec = [], [], []
    for lo, hi in tcode.plan.group_slices:
        v, _, host = approx_mod.host_solve(code, pres[lo:hi])
        vs.append(v)
        bounds_sq.append(host["bound"] ** 2)
        rec.append(host["recovered_fraction"])
    v = torch.cat(vs)
    vn_pres = torch.stack([v / tcode.n, pres])
    return v, vn_pres, {
        "bound": torch.sqrt(torch.stack(bounds_sq).sum()),
        "recovered_fraction": torch.stack(rec).mean()}

