"""Carry trained JAX parameters and optimizer state into the port's
models.

The JAX package's arrays are taken as numpy arrays (``np.asarray`` of each
leaf), so this module needs no JAX.
"""
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["bprmf_params_from_jax", "two_tables_from_jax",
           "lightgcl_params_from_jax", "dens_params_from_jax",
           "linear_port_name", "selfcf_params_from_jax",
           "cdae_params_from_jax", "multvae_params_from_jax",
           "fpmc_params_from_jax", "transrec_params_from_jax",
           "caser_params_from_jax", "hgn_params_from_jax",
           "flatten_jax_tree", "gru4rec_params_from_jax",
           "sasrec_params_from_jax", "bert4rec_params_from_jax",
           "srgnn_params_from_jax", "bm3_params_from_jax",
           "slmrec_params_from_jax", "freedom_params_from_jax",
           "mgcn_params_from_jax", "lattice_params_from_jax",
           "adam_state_from_jax", "flat_adam_state_from_jax",
           "lazy_adam_state_from_jax", "adagrad_state_from_jax"]

DENS_GATES = ("item_gate", "neg_gate", "pos_gate", "user_gate")


def _tensors(params: Dict[str, np.ndarray], keys: Tuple[str, ...]
             ) -> Dict[str, torch.Tensor]:
    if set(params) != set(keys):
        raise ValueError(f"expected keys {keys}, got {sorted(params)}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32))
            for k in keys}


def bprmf_params_from_jax(params: Dict[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """``{"user_emb": (U, d), "item_emb": (N, d), "item_bias": (N,)}`` f32
    CPU tensors from a JAX BPRMF's ``params``."""
    out = _tensors(params, ("user_emb", "item_emb", "item_bias"))
    u, i, b = out["user_emb"], out["item_emb"], out["item_bias"]
    if (u.dim() != 2 or i.dim() != 2 or b.dim() != 1
            or u.shape[1] != i.shape[1] or b.shape[0] != i.shape[0]):
        raise ValueError(f"inconsistent shapes: user_emb {tuple(u.shape)}, "
                         f"item_emb {tuple(i.shape)}, item_bias "
                         f"{tuple(b.shape)}")
    return out


def two_tables_from_jax(params: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """``{"user_emb": (U, d), "item_emb": (N, d)}`` f32 CPU tensors from
    the ``params`` of a JAX LightGCN or LayerGCN (their ego embeddings),
    AOBPR or CML (Pop has none)."""
    return _two_tables(params, "user_emb", "item_emb")


def _two_tables(params: Dict[str, np.ndarray], user: str, item: str
                ) -> Dict[str, torch.Tensor]:
    out = _tensors(params, (user, item))
    u, i = out[user], out[item]
    if u.dim() != 2 or i.dim() != 2 or u.shape[1] != i.shape[1]:
        raise ValueError(f"inconsistent shapes: {user} {tuple(u.shape)}, "
                         f"{item} {tuple(i.shape)}")
    return out


def lightgcl_params_from_jax(params: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """``{"E_u_0": (U, d), "E_i_0": (N, d)}`` f32 CPU tensors from a JAX
    LightGCL's ``params`` (its ego embeddings)."""
    return _two_tables(params, "E_u_0", "E_i_0")


def linear_port_name(key: str) -> Tuple[str, bool]:
    """(the port's parameter name, transposed?) of a leaf of a JAX model's
    params by its path: a layer ``x @ w + b`` at ``<path>`` (a DENS gate,
    ``user_gate``; a MultVAE layer, ``q/0``) is an ``nn.Linear`` at the
    dotted path, which holds ``w.T`` as ``weight`` and ``b`` as ``bias``;
    another leaf keeps its name."""
    path, _, leaf = key.rpartition("/")
    if path and leaf in ("w", "b"):
        name = path.replace("/", ".")
        return (f"{name}.weight", True) if leaf == "w" \
            else (f"{name}.bias", False)
    return key, False


def dens_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX DENS's nested ``params`` (``user_emb``, ``item_emb`` and the
    gates ``{"w": (d, d), "b": (d,)}``) as f32 CPU tensors by the port's
    parameter names (``user_gate.weight`` = ``w.T`` ...)."""
    keys = ("user_emb", "item_emb") + DENS_GATES
    if set(params) != set(keys):
        raise ValueError(f"expected keys {keys}, got {sorted(params)}")
    out = two_tables_from_jax({k: params[k] for k in ("user_emb",
                                                      "item_emb")})
    d = out["user_emb"].shape[1]
    for gate in DENS_GATES:
        leaves = _tensors(params[gate], ("w", "b"))
        if leaves["w"].shape != (d, d) or leaves["b"].shape != (d,):
            raise ValueError(f"{gate}: w {tuple(leaves['w'].shape)}, b "
                             f"{tuple(leaves['b'].shape)}, tables of width "
                             f"{d}")
        for leaf, value in leaves.items():
            name, transposed = linear_port_name(f"{gate}/{leaf}")
            out[name] = value.T.contiguous() if transposed else value
    return out


def selfcf_params_from_jax(params: Dict[str, np.ndarray]
                           ) -> Dict[str, torch.Tensor]:
    """A JAX SelfCF's ``params`` (``user_emb``, ``item_emb``, the predictor
    ``x @ pred_w + pred_b``) as f32 CPU tensors by the port's parameter
    names: ``predictor.weight`` = ``pred_w.T``, ``predictor.bias`` =
    ``pred_b``."""
    keys = ("user_emb", "item_emb", "pred_w", "pred_b")
    out = _tensors(params, keys)
    tables = _two_tables({k: params[k] for k in keys[:2]}, *keys[:2])
    d = tables["user_emb"].shape[1]
    w, b = out["pred_w"], out["pred_b"]
    if w.shape != (d, d) or b.shape != (d,):
        raise ValueError(f"pred_w {tuple(w.shape)}, pred_b {tuple(b.shape)}, "
                         f"tables of width {d}")
    return dict(tables, **{"predictor.weight": w.T.contiguous(),
                           "predictor.bias": b})


def cdae_params_from_jax(params: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """A JAX CDAE's ``params`` as f32 CPU tensors of the same names:
    ``en_emb`` and ``de_emb`` (N, d), ``en_offset`` (d,), ``de_bias`` (N,),
    ``user_emb`` (U, d)."""
    out = _tensors(params, ("en_emb", "en_offset", "de_emb", "de_bias",
                            "user_emb"))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    n, d = shapes["en_emb"] if len(shapes["en_emb"]) == 2 else (-1, -1)
    want = {"en_emb": (n, d), "en_offset": (d,), "de_emb": (n, d),
            "de_bias": (n,), "user_emb": (shapes["user_emb"][0], d)}
    if n < 0 or shapes != want:
        raise ValueError(f"inconsistent shapes: {shapes}")
    return out


def multvae_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX MultVAE's nested ``params`` (``{"q": [{"w", "b"}, ...], "p":
    [...]}``) as f32 CPU tensors by the port's parameter names
    (``q.0.weight`` = ``w.T``, ``q.0.bias`` = ``b``, ...). Each network's
    layers must chain, the decoder end where the encoder starts, and the
    encoder's last layer give a mean and a log-variance of the decoder's
    input width."""
    if set(params) != {"p", "q"}:
        raise ValueError(f"expected keys ('p', 'q'), got {sorted(params)}")
    out, dims = {}, {}
    for net in ("q", "p"):
        widths = []
        for i, layer in enumerate(params[net]):
            leaves = _tensors(layer, ("w", "b"))
            w, b = leaves["w"], leaves["b"]
            if (w.dim() != 2 or b.shape != (w.shape[1],)
                    or (widths and widths[-1] != w.shape[0])):
                raise ValueError(f"{net}/{i}: w {tuple(w.shape)}, b "
                                 f"{tuple(b.shape)} after widths {widths}")
            widths = (widths or [w.shape[0]]) + [w.shape[1]]
            out[f"{net}.{i}.weight"] = w.T.contiguous()
            out[f"{net}.{i}.bias"] = b
        dims[net] = widths
    q, p = dims["q"], dims["p"]
    if not q or not p or q[0] != p[-1] or q[-1] != 2 * p[0]:
        raise ValueError(f"encoder widths {q} do not match decoder widths "
                         f"{p}")
    return out


def _check_shapes(shapes: Dict[str, tuple], want: Dict[str, tuple]) -> None:
    if shapes != want:
        bad = {k: (shapes[k], want[k]) for k in want if shapes[k] != want[k]}
        raise ValueError(f"inconsistent shapes (got, expected): {bad}")


def fpmc_params_from_jax(params: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """A JAX FPMC's ``params`` as f32 CPU tensors of the same names:
    ``UI`` (U, d); ``IU``, ``IL`` and ``LI`` (N, d)."""
    out = _tensors(params, ("UI", "IU", "IL", "LI"))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    u, d = (shapes["UI"] + (-1, -1))[:2]
    n = (shapes["IU"] + (-1,))[0]
    _check_shapes(shapes, {"UI": (u, d), "IU": (n, d), "IL": (n, d),
                           "LI": (n, d)})
    return out


def transrec_params_from_jax(params: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """A JAX TransRec's ``params`` as f32 CPU tensors of the same names:
    ``user_emb`` (U, d), ``item_emb`` (N, d), ``trans`` (1, d),
    ``item_bias`` (N,)."""
    out = _tensors(params, ("user_emb", "item_emb", "trans", "item_bias"))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    n, d = (shapes["item_emb"] + (-1, -1))[:2]
    _check_shapes(shapes, {"user_emb": (shapes["user_emb"][0], d),
                           "item_emb": (n, d), "trans": (1, d),
                           "item_bias": (n,)})
    return out


def _leaf_lists(params: Dict, lists: Tuple[str, ...], length: int
                ) -> Dict[str, np.ndarray]:
    """``params`` with each list-valued key in ``lists`` (of ``length``
    entries) flattened into ``<key>.<i>`` (the port's ``nn.ParameterList``
    names)."""
    flat = {k: v for k, v in params.items() if k not in lists}
    for key in lists:
        if len(params[key]) != length:
            raise ValueError(f"{key}: {len(params[key])} entries, expected "
                             f"{length}")
        flat.update({f"{key}.{i}": v for i, v in enumerate(params[key])})
    return flat


def caser_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX Caser's ``params`` as f32 CPU tensors in the same layout, the
    lists of the horizontal convolutions flattened to ``conv_h.<i>`` and
    ``conv_h_b.<i>``: ``user_emb`` (U, d), ``item_emb`` (N + 1, d),
    ``conv_v`` (L, 1, nv), ``conv_v_b`` (nv,), ``conv_h.<i>`` (i + 1, d,
    nh), ``conv_h_b.<i>`` (nh,), ``fc1_w`` (nv d + nh L, d), ``fc1_b``
    (d,), ``W2`` (N + 1, 2d), ``b2`` (N + 1,)."""
    keys = ("user_emb", "item_emb", "conv_v", "conv_v_b", "conv_h",
            "conv_h_b", "fc1_w", "fc1_b", "W2", "b2")
    if set(params) != set(keys):
        raise ValueError(f"expected keys {keys}, got {sorted(params)}")
    conv_v = np.asarray(params["conv_v"])
    if conv_v.ndim != 3:
        raise ValueError(f"conv_v {conv_v.shape}, expected (L, 1, nv)")
    big_l, _, nv = conv_v.shape
    flat = _leaf_lists(params, ("conv_h", "conv_h_b"), big_l)
    out = _tensors(flat, tuple(flat))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    n, d = (shapes["item_emb"] + (-1, -1))[:2]
    nh = (shapes["conv_h_b.0"] + (-1,))[0]
    want = {"user_emb": (shapes["user_emb"][0], d), "item_emb": (n, d),
            "conv_v": (big_l, 1, nv), "conv_v_b": (nv,),
            "fc1_w": (nv * d + nh * big_l, d), "fc1_b": (d,),
            "W2": (n, 2 * d), "b2": (n,)}
    for i in range(big_l):
        want[f"conv_h.{i}"] = (i + 1, d, nh)
        want[f"conv_h_b.{i}"] = (nh,)
    _check_shapes(shapes, want)
    return out


def hgn_params_from_jax(params: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """A JAX HGN's ``params`` as f32 CPU tensors of the same names:
    ``user_emb`` (U, d), ``item_emb`` and ``W2`` (N + 1, d), ``b2`` (N + 1,),
    the feature gates ``fg_item_w``, ``fg_user_w`` (d, d) and ``fg_item_b``,
    ``fg_user_b`` (d,), the instance gates ``ig_item`` (d, 1) and
    ``ig_user`` (d, L)."""
    keys = ("user_emb", "item_emb", "fg_item_w", "fg_item_b", "fg_user_w",
            "fg_user_b", "ig_item", "ig_user", "W2", "b2")
    out = _tensors(params, keys)
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    n, d = (shapes["item_emb"] + (-1, -1))[:2]
    big_l = (shapes["ig_user"] + (-1, -1))[1]
    _check_shapes(shapes, {
        "user_emb": (shapes["user_emb"][0], d), "item_emb": (n, d),
        "fg_item_w": (d, d), "fg_item_b": (d,), "fg_user_w": (d, d),
        "fg_user_b": (d,), "ig_item": (d, 1), "ig_user": (d, big_l),
        "W2": (n, d), "b2": (n,)})
    return out


def flatten_jax_tree(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested params tree (dicts and lists) as f32 CPU tensors by dotted
    path, a list's entries by index (``blocks.0.att.q.w``): the names of
    the port's nested parameters (``ParamTree``, ``nn.ModuleList``)."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        return {prefix: torch.from_numpy(np.array(params, dtype=np.float32))}
    out: Dict[str, torch.Tensor] = {}
    for key, value in items:
        out.update(flatten_jax_tree(value, f"{prefix}.{key}" if prefix
                                    else str(key)))
    return out


def _tree_from_jax(params, want: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """``flatten_jax_tree(params)``, checked against the expected leaves and
    shapes (``want``: dotted path -> shape)."""
    out = flatten_jax_tree(params)
    if set(out) != set(want):
        raise ValueError(f"expected leaves {sorted(want)}, got "
                         f"{sorted(out)}")
    _check_shapes({k: tuple(v.shape) for k, v in out.items()}, want)
    return out


def _need(params: Dict, *keys: str) -> None:
    missing = [k for k in keys if k not in params]
    if missing:
        raise ValueError(f"missing leaves {missing}, got {sorted(params)}")


def _gru_cell_shapes(prefix: str, n_in: int, hid: int) -> Dict[str, tuple]:
    return {f"{prefix}.gate_w": (n_in + hid, 2 * hid),
            f"{prefix}.gate_b": (2 * hid,),
            f"{prefix}.cand_w": (n_in + hid, hid),
            f"{prefix}.cand_b": (hid,)}


def gru4rec_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX GRU4Rec's (or GRU4RecPlus's) ``params`` as f32 CPU tensors:
    ``input_emb`` (N, l_0), ``item_emb`` (N, l_last), ``item_bias`` (N,)
    and each TF GRU cell ``cells.<i>.{gate_w, gate_b, cand_w, cand_b}``."""
    _need(params, "item_bias", "cells")
    cells = params["cells"]
    widths = [int(np.shape(c["cand_b"])[0]) for c in cells]
    if not widths:
        raise ValueError("a GRU4Rec has at least one cell")
    n = int(np.shape(params["item_bias"])[0])
    want = {"input_emb": (n, widths[0]), "item_emb": (n, widths[-1]),
            "item_bias": (n,)}
    for i, hid in enumerate(widths):
        want.update(_gru_cell_shapes(f"cells.{i}",
                                     widths[max(i - 1, 0)], hid))
    return _tree_from_jax(params, want)


def _dense_shapes(prefix: str, n_in: int, n_out: int) -> Dict[str, tuple]:
    return {f"{prefix}.w": (n_in, n_out), f"{prefix}.b": (n_out,)}


def sasrec_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX SASRec's ``params`` as f32 CPU tensors: ``item_emb`` (N, d),
    ``pos_emb`` (L, d), ``ln_f_s``, ``ln_f_b`` (d,) and each block's
    ``blocks.<i>.{ln1_s, ln1_b, ln2_s, ln2_b}``, ``att.{q, k, v}.{w,
    b}`` and ``ffn.{ff1, ff2}.{w, b}`` (d, d), (d,)."""
    _need(params, "item_emb", "pos_emb")
    n, d = np.shape(params["item_emb"])
    big_l = np.shape(params["pos_emb"])[0]
    want = {"item_emb": (n, d), "pos_emb": (big_l, d), "ln_f_s": (d,),
            "ln_f_b": (d,)}
    for i in range(len(params.get("blocks") or [])):
        pre = f"blocks.{i}"
        for name in ("ln1_s", "ln1_b", "ln2_s", "ln2_b"):
            want[f"{pre}.{name}"] = (d,)
        for name in ("q", "k", "v"):
            want.update(_dense_shapes(f"{pre}.att.{name}", d, d))
        for name in ("ff1", "ff2"):
            want.update(_dense_shapes(f"{pre}.ffn.{name}", d, d))
    return _tree_from_jax(params, want)


def bert4rec_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX BERT4Rec's ``params`` as f32 CPU tensors: ``tok_emb`` (N + 2,
    d), ``pos_emb`` (L, d), ``ln_e_s``, ``ln_e_b``, ``mlm_ln_s``,
    ``mlm_ln_b`` (d,), ``mlm_dense.{w, b}``, ``out_bias`` (N + 2,) and each
    block's ``blocks.<i>.{q, k, v, att_out}.{w, b}`` (d, d), ``ff1`` (d,
    4d), ``ff2`` (4d, d) and ``{ln1, ln2}_{s, b}``."""
    _need(params, "tok_emb", "pos_emb")
    vocab, d = np.shape(params["tok_emb"])
    big_l = np.shape(params["pos_emb"])[0]
    want = {"tok_emb": (vocab, d), "pos_emb": (big_l, d), "ln_e_s": (d,),
            "ln_e_b": (d,), "mlm_ln_s": (d,), "mlm_ln_b": (d,),
            "out_bias": (vocab,), **_dense_shapes("mlm_dense", d, d)}
    for i in range(len(params.get("blocks") or [])):
        pre = f"blocks.{i}"
        for name in ("q", "k", "v", "att_out"):
            want.update(_dense_shapes(f"{pre}.{name}", d, d))
        want.update(_dense_shapes(f"{pre}.ff1", d, 4 * d))
        want.update(_dense_shapes(f"{pre}.ff2", 4 * d, d))
        for name in ("ln1_s", "ln1_b", "ln2_s", "ln2_b"):
            want[f"{pre}.{name}"] = (d,)
    return _tree_from_jax(params, want)


def srgnn_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX SRGNN's ``params`` as f32 CPU tensors: ``embedding`` (N, d),
    ``nasr_w1``, ``nasr_w2``, ``W_in``, ``W_out`` (d, d), ``nasr_v`` (1,
    d), ``nasr_b``, ``b_in``, ``b_out`` (d,), ``B`` (2d, d) and the TF GRU
    cell ``gru.{gate_w, gate_b, cand_w, cand_b}`` over 2d inputs."""
    _need(params, "embedding")
    n, d = np.shape(params["embedding"])
    want = {"embedding": (n, d), "nasr_w1": (d, d), "nasr_w2": (d, d),
            "nasr_v": (1, d), "nasr_b": (d,), "W_in": (d, d), "b_in": (d,),
            "W_out": (d, d), "b_out": (d,), "B": (2 * d, d),
            **_gru_cell_shapes("gru", 2 * d, d)}
    return _tree_from_jax(params, want)


def _modality_shapes(params: Dict, n: int, out_dim: int
                     ) -> Dict[str, tuple]:
    """The expected shapes of the feature tables and projectors present in a
    multimodal model's ``params`` (``v_feat`` with ``image_trs``, ``t_feat``
    with ``text_trs``), projecting to ``out_dim``."""
    want = {}
    for feat, trs in (("v_feat", "image_trs"), ("t_feat", "text_trs")):
        if feat in params:
            f = int(np.shape(params[feat])[-1])
            want.update({feat: (n, f),
                         **_dense_shapes(trs, f, out_dim)})
    return want


def _tables_shapes(params: Dict) -> Tuple[Dict[str, tuple], int, int]:
    _need(params, "user_emb", "item_emb")
    u, d = np.shape(params["user_emb"])
    n = np.shape(params["item_emb"])[0]
    return {"user_emb": (u, d), "item_emb": (n, d)}, int(n), int(d)


def bm3_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX BM3's ``params`` as f32 CPU tensors by dotted path:
    ``user_emb`` (U, d), ``item_emb`` (N, d), ``pred_w`` (d, d),
    ``pred_b`` (d,) and, per modality present, ``v_feat`` (N, F) with
    ``image_trs.{w, b}`` (F, d), (d,), ``t_feat`` with ``text_trs``."""
    want, n, d = _tables_shapes(params)
    want.update({"pred_w": (d, d), "pred_b": (d,),
                 **_modality_shapes(params, n, d)})
    return _tree_from_jax(params, want)


def slmrec_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX SLMRec's ``params`` as f32 CPU tensors by dotted path:
    ``user_emb``, ``item_emb`` (U or N, d), the projections ``v_dense``,
    ``t_dense`` (F, d), ``after_gcn_u``, ``after_gcn_i`` (3d or d, d) as
    ``{w, b}``, and under the FAC task ``g_i_iv``, ``g_v_iv``,
    ``g_iv_iva`` (d, d), ``g_iva_ivat``, ``g_t_ivat`` (d, d // 2)."""
    want, n, d = _tables_shapes(params)
    _need(params, "v_dense", "t_dense", "after_gcn_u")
    fused = int(np.shape(params["after_gcn_u"]["w"])[0])
    for name in ("v_dense", "t_dense"):
        want.update(_dense_shapes(
            name, int(np.shape(params[name]["w"])[0]), d))
    for name in ("after_gcn_u", "after_gcn_i"):
        want.update(_dense_shapes(name, fused, d))
    if "g_i_iv" in params:
        for name in ("g_i_iv", "g_v_iv", "g_iv_iva"):
            want.update(_dense_shapes(name, d, d))
        for name in ("g_iva_ivat", "g_t_ivat"):
            want.update(_dense_shapes(name, d, d // 2))
    return _tree_from_jax(params, want)


def freedom_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX FREEDOM's ``params`` as f32 CPU tensors by dotted path:
    ``user_emb``, ``item_emb`` and, per modality present, its feature table
    and projector (``v_feat``, ``image_trs.{w, b}``; ``t_feat``,
    ``text_trs``) to ``feat_dim``."""
    want, n, _ = _tables_shapes(params)
    trs = params.get("image_trs") or params.get("text_trs")
    if trs is None:
        raise ValueError("a FREEDOM has at least one modality")
    want.update(_modality_shapes(params, n, int(np.shape(trs["b"])[0])))
    return _tree_from_jax(params, want)


def mgcn_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX MGCN's ``params`` as f32 CPU tensors by dotted path:
    ``user_emb``, ``item_emb`` (d wide), ``v_feat`` and ``t_feat`` with
    ``image_trs``, ``text_trs`` (F, d), ``query1``, the gates ``gate_v``,
    ``gate_t``, ``gate_image_prefer``, ``gate_text_prefer`` (d, d) as
    ``{w, b}``, and ``query2.w`` (d, 1) without a bias."""
    want, n, d = _tables_shapes(params)
    _need(params, "v_feat", "t_feat")
    want.update(_modality_shapes(params, n, d))
    for name in ("query1", "gate_v", "gate_t", "gate_image_prefer",
                 "gate_text_prefer"):
        want.update(_dense_shapes(name, d, d))
    want["query2.w"] = (d, 1)
    return _tree_from_jax(params, want)


def lattice_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX LATTICE's ``params`` as f32 CPU tensors by dotted path:
    ``user_emb``, ``item_emb``, ``modal_weight`` (2,), per modality present
    its feature table and projector to ``feat_embed_dim``, and with
    ``cf_model="ngcf"`` the layers ``gc.<i>`` and ``bi.<i>`` as ``{w,
    b}``."""
    want, n, d = _tables_shapes(params)
    trs = params.get("image_trs") or params.get("text_trs")
    if trs is None:
        raise ValueError("a LATTICE has at least one modality")
    want.update({"modal_weight": (2,),
                 **_modality_shapes(params, n, int(np.shape(trs["b"])[0]))})
    gc, bi = params.get("gc"), params.get("bi")
    if (gc is None) != (bi is None) or (gc is not None
                                        and len(gc) != len(bi)):
        raise ValueError("ngcf layers come as gc and bi of one length")
    width = d
    for i, layer in enumerate(gc or []):
        out = int(np.shape(layer["b"])[0])
        want.update({**_dense_shapes(f"gc.{i}", width, out),
                     **_dense_shapes(f"bi.{i}", width, out)})
        width = out
    return _tree_from_jax(params, want)


def _path_key(key: str) -> tuple:
    """The sort key of a leaf path: list indices by number."""
    return tuple(int(part) if part.isdigit() else part
                 for part in key.split("/"))


def adam_state_from_jax(count: int, mu: np.ndarray, nu: np.ndarray,
                        shapes: Dict[str, Tuple[int, ...]]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-parameter ``torch.optim.Adam`` state (``step``, ``exp_avg``,
    ``exp_avg_sq``, CPU tensors) from a JAX model's ``optax.adam`` state
    over its raveled parameters: ``count`` and the flat ``mu`` and ``nu``.
    ``ravel_pytree`` concatenates a dict's leaves by sorted key (BPRMF:
    ``item_bias``, ``item_emb``, ``user_emb``; LightGCN: ``item_emb``,
    ``user_emb``; a nested dict by its leaves' paths, ``item_gate/b``
    before ``item_gate/w``; a list by index, ``p/2/b`` before ``p/10/b``);
    ``shapes`` gives each leaf's shape by its path. optax's count and
    torch's step both count the updates taken."""
    mu = np.asarray(mu, dtype=np.float32).reshape(-1)
    nu = np.asarray(nu, dtype=np.float32).reshape(-1)
    total = sum(int(np.prod(s)) for s in shapes.values())
    if mu.shape != (total,) or nu.shape != (total,):
        raise ValueError(f"mu and nu must hold {total} values, got "
                         f"{mu.shape} and {nu.shape}")
    out, lo = {}, 0
    for key in sorted(shapes, key=_path_key):
        size = int(np.prod(shapes[key]))
        out[key] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(
                mu[lo:lo + size].reshape(shapes[key]).copy()),
            "exp_avg_sq": torch.from_numpy(
                nu[lo:lo + size].reshape(shapes[key]).copy())}
        lo += size
    return out


def flat_adam_state_from_jax(count: int, mu: np.ndarray, nu: np.ndarray,
                             size: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(step, exp_avg, exp_avg_sq)``, f32 CPU tensors, of one
    ``torch.optim.Adam`` over a model's flat parameter vector of ``size``
    values (:class:`~skrx_torch.models.common.FlatTrainStep`) from a JAX
    model's ``optax.adam`` state over its raveled parameters: the flat
    vector follows JAX's ravel order, so ``mu`` and ``nu`` go in as they
    are. A learning-rate schedule's count (MGCN's ``scale_by_schedule``)
    equals Adam's ``count``, and the step count stands for both."""
    mu = np.asarray(mu, dtype=np.float32).reshape(-1)
    nu = np.asarray(nu, dtype=np.float32).reshape(-1)
    if mu.shape != (size,) or nu.shape != (size,):
        raise ValueError(f"mu and nu must hold {size} values, got "
                         f"{mu.shape} and {nu.shape}")
    return (torch.tensor(float(count), dtype=torch.float32),
            torch.from_numpy(mu.copy()), torch.from_numpy(nu.copy()))


def lazy_adam_state_from_jax(m: np.ndarray, v: np.ndarray,
                             counts: np.ndarray) -> Dict[str, torch.Tensor]:
    """One table's lazy Adam state (``skrx_torch.ops.optim.LazyAdam``'s
    ``m``, ``v`` f32 and ``counts`` int32, CPU tensors) from a JAX
    ``LazyAdamState`` (m, v, counts)."""
    m = np.array(m, dtype=np.float32)
    v = np.array(v, dtype=np.float32)
    counts = np.array(counts, dtype=np.int32)
    if m.shape != v.shape or counts.shape != m.shape[:1]:
        raise ValueError(f"inconsistent lazy Adam state: m {m.shape}, v "
                         f"{v.shape}, counts {counts.shape}")
    return {"m": torch.from_numpy(m), "v": torch.from_numpy(v),
            "counts": torch.from_numpy(counts)}


def adagrad_state_from_jax(sum_of_squares: Dict[str, np.ndarray],
                           shapes: Dict[str, Tuple[int, ...]]
                           ) -> Dict[str, torch.Tensor]:
    """Per-parameter ``OptaxAdagrad`` accumulators (f32 CPU tensors) from
    the ``sum_of_squares`` of an ``optax.adagrad`` state over a JAX model's
    params dict; ``shapes`` gives each parameter's shape."""
    if set(sum_of_squares) != set(shapes):
        raise ValueError(f"expected accumulators of {sorted(shapes)}, got "
                         f"{sorted(sum_of_squares)}")
    out = {}
    for key, shape in shapes.items():
        acc = np.array(sum_of_squares[key], dtype=np.float32)
        if acc.shape != tuple(shape):
            raise ValueError(f"{key}: accumulator {acc.shape}, parameter "
                             f"{tuple(shape)}")
        out[key] = torch.from_numpy(acc)
    return out
