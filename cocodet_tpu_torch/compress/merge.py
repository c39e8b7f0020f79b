"""Step 03 of the compression chain (cocodet_tpu/compress/merge.py): the
deployment tree (BN folded, ``conv_mask`` and ChannelMask gates folded), the
physical removal of ChannelMask-dead channels from it with the width spec
that ``models.build_model(slim=...)`` takes, the spec's json reader and the
effective-parameter count of the reference's 25.1M.

``merge_for_deployment`` is ``ops/fuse.py::fuse_batchnorm_tree``.
``slim_channels`` is numpy on flax-layout trees, as in JAX: the spec equals
JAX's, and so do the slimmed arrays given the same fused tree. The constant
a removed channel feeds forward, ``act(offset)``, goes through the port's
own hard-swish (``models/blocks.py::get_activation``), which equals
``jax.nn.hard_swish`` bit for bit on the CPU.

What each case of ``slim_channels`` removes and folds (merge.py:9-43):

  * bottleneck conv1: its dead output channels, from conv1 and from conv2's
    input; the constant act(offset) they fed forward into conv2's bias
    (exact inside the map; a k > 1 conv2's zero-padded rim never saw the
    constant, so with non-zero offsets the rim differs; with offset 0 it is
    exact everywhere, act(0) = 0);
  * bottleneck conv2 in a shortcut-free chain: from conv2 and the next
    bottleneck's (1x1) conv1 input, or the CSP conv3's first concat rows for
    the last bottleneck: exact;
  * residual streams (CSP conv1 and every bottleneck conv2, tied masks):
    a channel dead at every tied site, with the constant it accumulates
    along the chain folded into each bottleneck conv1 and conv3 (all 1x1):
    exact; spec pin "res";
  * depthwise bottlenecks stay unslimmed;
  * head stems and cls/reg towers: into each consumer's bias (the rim
    caveat of conv1 for the 3x3 towers);
  * the stem, stage down convs, SPP convs, FPN laterals and bu convs, and
    every CSP bypass (conv2), whose widths the spec pins.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.blocks import get_activation
from ..ops.fuse import fuse_batchnorm_tree
from ..utils.convert import flatten_tree, unflatten_tree

logger = logging.getLogger("cocodet_tpu_torch")


def merge_for_deployment(variables: Mapping[str, Any], eps: float = 1e-3) -> Dict[str, Any]:
    """BN fold with the ``conv_mask`` and ChannelMask gates folded in: the
    dense fused ``{"params": ...}`` (merge.py:58-61)."""
    return fuse_batchnorm_tree(dict(variables), eps=eps)


# --------------------------------------------------------------------------
# channel slimming of fused param trees
# --------------------------------------------------------------------------


def _act_const(act_fn, offset: np.ndarray, removed: np.ndarray) -> np.ndarray:
    """Constant a dead channel feeds forward: act(offset) on removed slots."""
    out = act_fn(torch.from_numpy(np.ascontiguousarray(offset, np.float32)))
    return out.numpy() * removed


def slim_channels(fused_variables: Mapping[str, Any], masks: Mapping[str, Any],
                  act: str = "hard_swish", round_to: int = 32
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Physically drop ChannelMask-dead channels from a FUSED param tree.

    Returns (slimmed {"params": ...}, slim_spec) where slim_spec maps
    "<csp_module_name>" -> {bottleneck_index: (hidden_width, out_width)}
    suitable for models.build_model(slim={...}) (keys are relative to the
    backbone scope, e.g. "dark3_csp").

    round_to: surviving-channel counts are rounded UP to this multiple by
    RETAINING that many already-dead channels (their folded kernel slices
    are zero, so outputs are bit-identical), so that the narrower convs keep
    widths the tensor cores tile well. Set 1 to disable.
    """

    def _round_keep(keep: np.ndarray) -> np.ndarray:
        if not keep.any():  # defensive: a conv must keep >= 1 channel
            keep = keep.copy()
            keep[0] = True
        if round_to <= 1:
            return keep
        kept = int(keep.sum())
        target = min(-(-kept // round_to) * round_to, keep.size)
        extra = target - kept
        if extra > 0:
            keep = keep.copy()
            keep[np.where(~keep)[0][:extra]] = True
        return keep
    params = dict(flatten_tree(fused_variables["params"]))
    mflat = flatten_tree(masks)
    act_fn = get_activation(act)

    # group mask scopes by csp module: path (..., "<csp>", "m<i>", "<conv>")
    by_bottleneck: Dict[Tuple, Dict[str, Tuple]] = {}
    for path in mflat:
        if path[-2:] != ("mask", "scale"):
            continue
        scope = path[:-2]          # (..., "m<i>", "conv1"/"conv2")
        b_scope, conv = scope[:-1], scope[-1]
        if not (b_scope and b_scope[-1].startswith("m")
                and b_scope[-1][1:].isdigit()):
            continue
        by_bottleneck.setdefault(b_scope, {})[conv] = scope

    spec: Dict[str, Dict[int, Tuple[Optional[int], Optional[int]]]] = {}
    removed_hidden = removed_out = 0

    def k_of(scope):
        return scope + ("conv", "kernel")

    def b_of(scope):
        return scope + ("conv", "bias")

    def _consumer_fold(cscope, rows, keep, const):
        """Fold the removed-channel constant into one consumer and slice the
        producer's rows out of its input dim. rows: "all" | ("first", n) |
        ("last", n) | ("blocks", n) — the producer occupies n repeated
        blocks spanning the whole input (SPP's [x, pool5, pool9, pool13])."""
        ck, cb = k_of(cscope), b_of(cscope)
        w = np.asarray(params[ck])
        n_in = w.shape[2]
        if rows != "all" and rows[0] == "blocks":
            n_blocks = rows[1]
            bw = n_in // n_blocks
            bias = np.asarray(params[cb])
            parts = []
            for bi in range(n_blocks):
                sub = w[:, :, bi * bw:(bi + 1) * bw, :]
                bias = bias + np.einsum("hwio,i->o", sub, const)
                parts.append(sub[:, :, keep, :])
            params[cb] = bias
            params[ck] = np.concatenate(parts, axis=2)
            return
        lo, hi = {"all": (0, n_in),
                  "first": (0, rows[1] if rows != "all" else n_in),
                  "last": (n_in - (rows[1] if rows != "all" else 0), n_in)
                  }[rows if rows == "all" else rows[0]]
        sub = w[:, :, lo:hi, :]
        params[cb] = (np.asarray(params[cb])
                      + np.einsum("hwio,i->o", sub, const))
        params[ck] = np.concatenate(
            [w[:, :, :lo], sub[:, :, keep, :], w[:, :, hi:]], axis=2)

    # residual CSP chains: conv1 carries a (group-leader) mask, tied to the
    # bottleneck conv2 masks; those conv2s are NOT chain-slimmable below
    residual_csps = set()
    for path in mflat:
        if path[-2:] == ("mask", "scale") and path[-3] == "conv1":
            csp = path[:-3]
            if k_of(csp + ("m0", "conv1")) in params:
                residual_csps.add(csp)

    for b_scope in sorted(by_bottleneck):
        convs = by_bottleneck[b_scope]
        csp_scope = b_scope[:-1]
        m_idx = int(b_scope[-1][1:])
        c1 = b_scope + ("conv1",)
        c2 = b_scope + ("conv2",)
        if k_of(c2) not in params:
            continue  # depthwise conv2 (dconv/pconv submodules) — skip
        hid_w = out_w = None

        # ---- conv1 output slimming ----
        if "conv1" in convs:
            scale = np.asarray(mflat[c1 + ("mask", "scale")])
            keep = _round_keep(scale > 0.0)
            if not keep.all():
                offset = np.asarray(mflat[c1 + ("mask", "offset")])
                const = _act_const(act_fn, offset, ~keep)
                w2 = np.asarray(params[k_of(c2)])
                params[b_of(c2)] = (np.asarray(params[b_of(c2)])
                                    + np.einsum("hwio,i->o", w2, const))
                params[k_of(c1)] = np.asarray(params[k_of(c1)])[..., keep]
                params[b_of(c1)] = np.asarray(params[b_of(c1)])[keep]
                params[k_of(c2)] = w2[..., keep, :]
                removed_hidden += int((~keep).sum())
            hid_w = int(keep.sum())

        # ---- conv2 output slimming (consumer = next bottleneck conv1,
        # or the CSP conv3's first concat rows for the LAST bottleneck).
        # Residual-chain conv2 masks are group members (handled below):
        # the chain fold is invalid there because the shortcut add keeps
        # the channel live even when conv2's contribution is constant.
        if "conv2" in convs and csp_scope not in residual_csps:
            scale = np.asarray(mflat[c2 + ("mask", "scale")])
            keep = _round_keep(scale > 0.0)
            nxt = csp_scope + (f"m{m_idx + 1}", "conv1")
            if k_of(nxt) in params:
                if not keep.all():
                    offset = np.asarray(mflat[c2 + ("mask", "offset")])
                    const = _act_const(act_fn, offset, ~keep)
                    wn = np.asarray(params[k_of(nxt)])  # 1x1: fold is exact
                    params[b_of(nxt)] = (np.asarray(params[b_of(nxt)])
                                         + np.einsum("hwio,i->o", wn, const))
                    params[k_of(c2)] = np.asarray(params[k_of(c2)])[..., keep]
                    params[b_of(c2)] = np.asarray(params[b_of(c2)])[keep]
                    params[k_of(nxt)] = wn[:, :, keep, :]
                    removed_out += int((~keep).sum())
                out_w = int(keep.sum())
            elif k_of(csp_scope + ("conv3",)) in params:
                # last bottleneck: its output is the x1 stream = the FIRST
                # rows of conv3's concat input (conv3 is 1x1 -> exact fold)
                if not keep.all():
                    offset = np.asarray(mflat[c2 + ("mask", "offset")])
                    const = _act_const(act_fn, offset, ~keep)
                    _consumer_fold(csp_scope + ("conv3",),
                                   ("first", keep.size), keep, const)
                    params[k_of(c2)] = np.asarray(params[k_of(c2)])[..., keep]
                    params[b_of(c2)] = np.asarray(params[b_of(c2)])[keep]
                    removed_out += int((~keep).sum())
                out_w = int(keep.sum())

        if hid_w is not None or out_w is not None:
            # spec key: csp module name relative to the backbone
            # (e.g. ("backbone", "backbone", "dark3_csp") -> "dark3_csp")
            key = csp_scope[-1]
            spec.setdefault(key, {})[m_idx] = (hid_w, out_w)

    # ---- residual-stream (group) slimming ------------------------------
    # A channel of the residual stream (csp conv1 out + every bottleneck
    # conv2 out, pre-add) is removable only when dead at ALL tied sites
    # (Pruner prunes the group jointly; intersection taken defensively).
    # The removed channel carries a CONSTANT along the chain:
    #   s0[d] = act(off_conv1[d]);  s_{i+1}[d] = s_i[d] + act(off_conv2_i[d])
    # folded into each bottleneck conv1 bias and conv3's first concat rows.
    # Every stream consumer is a 1x1 conv, so the fold is exact even with
    # bias-carrying offsets (no SAME-pad rim).
    removed_res = 0
    for csp_scope in sorted(residual_csps):
        leader = csp_scope + ("conv1",)
        dead = np.asarray(mflat[leader + ("mask", "scale")]) == 0.0
        m_scopes = []
        i = 0
        while k_of(csp_scope + (f"m{i}", "conv1")) in params:
            m_scopes.append(csp_scope + (f"m{i}",))
            i += 1
        for ms in m_scopes:
            sc = mflat.get(ms + ("conv2", "mask", "scale"))
            if sc is None:  # untied member -> nothing removable
                dead = np.zeros_like(dead)
                break
            dead &= np.asarray(sc) == 0.0
        keep = _round_keep(~dead)
        # pin the stream width (equals the default when nothing removed)
        spec.setdefault(csp_scope[-1], {})["res"] = int(keep.sum())
        if keep.all():
            continue
        rm = ~keep
        const = _act_const(
            act_fn, np.asarray(mflat[leader + ("mask", "offset")]), rm)
        for ms in m_scopes:
            c1, c2 = ms + ("conv1",), ms + ("conv2",)
            w1 = np.asarray(params[k_of(c1)])  # 1x1: fold is exact
            params[b_of(c1)] = (np.asarray(params[b_of(c1)])
                                + np.einsum("hwio,i->o", w1, const))
            params[k_of(c1)] = w1[:, :, keep, :]
            const = const + _act_const(
                act_fn, np.asarray(mflat[c2 + ("mask", "offset")]), rm)
            params[k_of(c2)] = np.asarray(params[k_of(c2)])[..., keep]
            params[b_of(c2)] = np.asarray(params[b_of(c2)])[keep]
        _consumer_fold(csp_scope + ("conv3",), ("first", keep.size),
                       keep, const)
        params[k_of(leader)] = np.asarray(params[k_of(leader)])[..., keep]
        params[b_of(leader)] = np.asarray(params[b_of(leader)])[keep]
        removed_res += int(rm.sum()) * (1 + len(m_scopes))

    # ---- decoupled-head tower slimming --------------------------------
    # producer conv -> its consumer convs (kernel input dim to slice).
    # stems/towers are ConvBnAct (fused: conv kernel+bias); preds are plain
    # 1x1 convs. 3x3 consumers share the conv1-path rim caveat (docstring).
    head_masks = sorted({p[1] for p in mflat
                         if p[0] == "head" and p[-2:] == ("mask", "scale")})
    removed_head = 0
    for name in head_masks:
        m = re.fullmatch(r"(stem|cls_conv|reg_conv)(\d+)(?:_(\d+))?", name)
        if not m:
            continue
        kind, k_lv, j = m.group(1), m.group(2), m.group(3)
        if kind == "stem":
            consumers = [f"cls_conv{k_lv}_0", f"reg_conv{k_lv}_0"]
        elif j == "0":
            consumers = [f"{kind}{k_lv}_1"]
        elif kind == "cls_conv":
            consumers = [f"cls_pred{k_lv}"]
        else:
            consumers = [f"reg_pred{k_lv}", f"obj_pred{k_lv}"]

        scope = ("head", name)
        keep = _round_keep(
            np.asarray(mflat[scope + ("mask", "scale")]) > 0.0)
        if keep.all():
            spec.setdefault("head", {})[name] = int(keep.size)
            continue
        offset = np.asarray(mflat[scope + ("mask", "offset")])
        const = _act_const(act_fn, offset, ~keep)
        for cname in consumers:
            ck = ("head", cname, "conv", "kernel")
            cb = ("head", cname, "conv", "bias")
            if ck not in params:  # plain pred conv (no ConvBnAct wrapper)
                ck = ("head", cname, "kernel")
                cb = ("head", cname, "bias")
            wc = np.asarray(params[ck])
            params[cb] = (np.asarray(params[cb])
                          + np.einsum("hwio,i->o", wc, const))
            params[ck] = wc[:, :, keep, :]
        params[k_of(scope)] = np.asarray(params[k_of(scope)])[..., keep]
        params[b_of(scope)] = np.asarray(params[b_of(scope)])[keep]
        removed_head += int((~keep).sum())
        spec.setdefault("head", {})[name] = int(keep.sum())

    # ---- stem / stage-down / FPN lateral / bu_conv slimming ------------
    # These producers feed csp conv1+conv2 entries (1x1 -> exact folds) or
    # the next 3x3 down conv (rim caveat). SPP-stage down convs are skipped:
    # SPP derives its hidden width from its input.
    removed_stage = 0
    producer_scopes = []
    for path in mflat:
        if path[-2:] != ("mask", "scale"):
            continue
        scope = path[:-2]
        name = scope[-1] if scope[-1] != "conv" else scope[-2]
        if (re.fullmatch(r"dark\d_down", name)
                or re.fullmatch(r"(lateral|bu_conv)\d", name)
                or name == "stem"):
            producer_scopes.append((scope, name))
        elif (len(scope) >= 2 and scope[-2].endswith("_spp")
              and name in ("conv1", "conv2")):
            producer_scopes.append((scope, f"spp_{name}"))
    # capture pre-slim producer widths (consumer row anchoring)
    full_w = {scope: int(np.asarray(params[k_of(scope)]).shape[-1])
              for scope, _ in producer_scopes}

    for scope, name in sorted(producer_scopes, key=lambda t: t[1]):
        pre = scope[:-1] if name != "stem" else scope[:-2]
        if name == "stem":
            consumers = [(pre + ("dark2_down",), "all")]
        elif name.endswith("_down"):
            stage = name[:-5]
            if k_of(pre + (f"{stage}_spp", "conv1")) in params:
                # SPP stage: the down conv feeds the SPP entry conv (1x1);
                # the input-derived hidden width gets pinned below
                consumers = [(pre + (f"{stage}_spp", "conv1"), "all")]
            else:
                consumers = [(pre + (f"{stage}_csp", "conv1"), "all"),
                             (pre + (f"{stage}_csp", "conv2"), "all")]
        elif name == "spp_conv1":
            # conv1's output appears 4x in conv2's concat input
            spp_scope = scope[:-1]
            consumers = [(spp_scope + ("conv2",), ("blocks", 4))]
        elif name == "spp_conv2":
            spp_scope = scope[:-1]
            stage = spp_scope[-1][:-4]  # "dark6_spp" -> "dark6"
            consumers = [(spp_scope[:-1] + (f"{stage}_csp", "conv1"), "all"),
                         (spp_scope[:-1] + (f"{stage}_csp", "conv2"), "all")]
        elif name.startswith("lateral"):
            k_lv = name[len("lateral"):]
            lw = full_w[scope]
            consumers = [(pre + (f"td_csp{k_lv}", "conv1"), ("first", lw)),
                         (pre + (f"td_csp{k_lv}", "conv2"), ("first", lw)),
                         (pre + (f"bu_csp{k_lv}", "conv1"), ("last", lw)),
                         (pre + (f"bu_csp{k_lv}", "conv2"), ("last", lw))]
        else:  # bu_conv{k}
            k_lv = name[len("bu_conv"):]
            bw = full_w[scope]
            consumers = [(pre + (f"bu_csp{k_lv}", "conv1"), ("first", bw)),
                         (pre + (f"bu_csp{k_lv}", "conv2"), ("first", bw))]

        keep = _round_keep(np.asarray(mflat[scope + ("mask", "scale")]) > 0.0)
        if not name.startswith("spp_"):  # spp widths recorded as pins below
            spec[name] = int(keep.sum())
        if keep.all():
            continue
        offset = np.asarray(mflat[scope + ("mask", "offset")])
        const = _act_const(act_fn, offset, ~keep)
        for cscope, rows in consumers:
            _consumer_fold(cscope, rows, keep, const)
        params[k_of(scope)] = np.asarray(params[k_of(scope)])[..., keep]
        params[b_of(scope)] = np.asarray(params[b_of(scope)])[keep]
        removed_stage += int((~keep).sum())

    # ---- CSP bypass (conv2) slimming: sole consumer is conv3 (1x1), and
    # the bypass occupies the LAST rows of conv3's concat input -----------
    for path in list(mflat):
        if path[-2:] != ("mask", "scale") or path[-3] != "conv2":
            continue
        scope = path[:-2]
        csp_scope = scope[:-1]
        if csp_scope and re.fullmatch(r"m\d+", csp_scope[-1]):
            continue  # bottleneck conv2: handled by the m-loop above
        if k_of(csp_scope + ("conv3",)) not in params:
            continue
        keep = _round_keep(np.asarray(mflat[path]) > 0.0)
        if not keep.all():
            offset = np.asarray(mflat[scope + ("mask", "offset")])
            const = _act_const(act_fn, offset, ~keep)
            _consumer_fold(csp_scope + ("conv3",), ("last", keep.size),
                           keep, const)
            params[k_of(scope)] = np.asarray(params[k_of(scope)])[..., keep]
            params[b_of(scope)] = np.asarray(params[b_of(scope)])[keep]
            removed_stage += int((~keep).sum())

    # pin every CSP bypass (conv2) width: custom CSPs derive it from the
    # (possibly slimmed) input width, so the checkpoint value must win
    for path in list(params):
        if path[-3:] != ("conv2", "conv", "kernel"):
            continue
        csp_scope = path[:-3]
        if k_of(csp_scope + ("conv3",)) in params:
            spec.setdefault(csp_scope[-1], {})["c2"] = int(
                np.asarray(params[path]).shape[-1])
        elif csp_scope[-1].endswith("_spp"):
            # SPP width pins (hidden is input-derived in the module)
            spec[csp_scope[-1]] = {
                "hidden": int(np.asarray(
                    params[k_of(csp_scope + ("conv1",))]).shape[-1]),
                "out": int(np.asarray(params[path]).shape[-1]),
            }

    logger.info(
        "slimmed %d hidden + %d inter-bottleneck + %d head + %d stage "
        "+ %d residual-stream channels", removed_hidden, removed_out,
        removed_head, removed_stage, removed_res)
    return {"params": unflatten_tree(params)}, spec


def load_slim_spec(path: str) -> Dict[str, Any]:
    """Read a slim-spec json (int keys restored) for build_model(slim=...)."""
    with open(path) as f:
        raw = json.load(f)

    def _conv(k, d):
        if isinstance(d, int):  # stem/down/lateral/bu_conv width
            return d
        if k == "head":         # head: {conv_name: width}
            return dict(d)
        # csp table: int bottleneck keys -> (hid, out); "c2" -> bypass width
        return {(int(i) if str(i).lstrip("-").isdigit() else i):
                (tuple(v) if isinstance(v, (list, tuple)) else v)
                for i, v in d.items()}

    return {k: _conv(k, d) for k, d in raw.items()}


def count_effective_params(variables: Mapping[str, Any],
                           masks: Optional[Mapping[str, Any]] = None
                           ) -> Tuple[int, int]:
    """(effective nonzero, total) across the tree's params; a conv with a
    ``conv_mask`` counts the mask's ones."""
    mflat = flatten_tree(masks) if masks else {}
    total = eff = 0
    for path, w in flatten_tree(variables["params"]).items():
        total += int(np.prod(np.shape(w)))
        m = mflat.get(path[:-1] + ("conv_mask",))
        if m is not None:
            eff += int(np.asarray(m).sum())
        else:
            eff += int(np.count_nonzero(np.asarray(w)))
    return eff, total
