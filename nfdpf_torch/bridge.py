"""Load the JAX package's parameters into the port's modules.

``variables`` is the JAX engine's pytree (``DPF.init`` there) as nested
dicts of numpy arrays: ``{"encoder": {"params": .., "batch_stats": ..},
"decoder": {..}, "nf_dyn": {"params": ..}, "cond_model": {"params": ..},
"measurement": {"params": ..}}``.  All five subtrees must be present: the
engine owns both flow chains whatever ``nf_dyn`` / ``nf_cond`` say, as the
JAX engine does.

Mapping rules:

* Conv kernels HWIO → OIHW;
* Dense kernels (in, out) → Linear weights (out, in);
* the encoder's flatten and the decoder's reshape run in NHWC order in both
  packages (see ``nets.py``), so the Dense rows need no permutation;
* ``nn.ConvTranspose(k4, s2, "SAME")`` equals
  ``ConvTranspose2d(k=4, s=2, p=1)`` only with the kernel flipped in both
  spatial axes: (kh, kw, in, out) → flip → (in, out, kh, kw);
* BatchNorm scale/bias → weight/bias, batch_stats mean/var → running
  mean/var;
* the RealNVP chains ``nf_dyn``, ``cond_model`` and the CRNVP
  measurement's ``cnf``:
  ``params/flows_{k}/{t1,s1,t2,s2}/Dense_{i}/{kernel,bias}`` →
  ``{chain}.flows.{k}.{t1,s1,t2,s2}.fc{i+1}.{weight,bias}``, kernels
  transposed like every Dense;
* the measurement's ``particle_encoder`` and (``NN``) ``likelihood_net``,
  and a ``TransitionMLP`` (``mlp_state_from_jax``): ``Dense_{i}`` →
  ``fc{i+1}``;
* any flow of the flow library, or a ``FlowChain`` of mixed flows
  (``flow_state_from_jax``, which reads the port's module for the kinds):
  ``flows_{k}`` → ``flows.{k}``; a conditioner's ``Dense_{j}`` → ``fc{j+1}``
  under its net (``t1``..``s2``, ``f1``/``f2``, MAF's and the
  autoregressive spline's ``layers_{i}`` → ``layers.{i}``); the flows'
  vectors (``initial_param``, ``init_param``, ``mu``/``log_sigma``,
  ``L``/``S``/``U``, ``w``/``u``/``b``, ``x0``/``log_alpha``/``beta``) by
  their names, and the LU map's ``constants/P`` → its buffer ``P``;
* the CGLOW measurement's ``cglow`` (``cglow_state_from_jax``):
  ``layer_mods_{i}`` → ``layer_mods.{i}``; a conditioning net's
  ``ConvResize_{i}/Conv_0`` → ``resize.{i}.conv`` with the (kh, kw, I, O)
  kernel flattened to its (kh·kw·I, O) matmul order, and
  ``DenseZeros_0``, ``DenseZeros_1``, ``DenseZeros_2``/``DenseNorm_0`` →
  ``dense.{0,1,2}``; the coupling's ``rx1``..``f3`` and the split's
  ``prior_conv`` keep their names, each ``Conv_0`` → ``conv``,
  ``ImageActNorm_0`` → ``actnorm``; ``top_mean``/``top_logs`` (with
  ``learn_top``) as they are.  A measurement subtree with no mapping is
  refused.

Every map is a permutation of entries, so ``torch_state_from_jax`` also
carries gradient pytrees (``params`` only) into the port's parameter names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nfdpf_torch.ops import flows
from nfdpf_torch.parallel.mesh import replicate


def _conv(k):
    return np.transpose(k, (3, 2, 0, 1))


def _deconv(k):
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


def _dense_w(k):
    return np.transpose(k)


def _f32(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32))


def _bn(out, prefix, params, stats, i):
    if params is not None:
        out[f"{prefix}.norms.{i}.weight"] = params[f"BatchNorm_{i}"]["scale"]
        out[f"{prefix}.norms.{i}.bias"] = params[f"BatchNorm_{i}"]["bias"]
    if stats is not None:
        out[f"{prefix}.norms.{i}.running_mean"] = stats[f"BatchNorm_{i}"]["mean"]
        out[f"{prefix}.norms.{i}.running_var"] = stats[f"BatchNorm_{i}"]["var"]


def _mlp(out, prefix, layers):
    """A three-layer MLP's ``Dense_{i}`` → ``{prefix}fc{i+1}``."""
    for i in range(3):
        out[f"{prefix}fc{i + 1}.weight"] = _dense_w(layers[f"Dense_{i}"]["kernel"])
        out[f"{prefix}fc{i + 1}.bias"] = layers[f"Dense_{i}"]["bias"]


def flow_chain_state_from_jax(chain_variables, prefix: str = "") -> Dict[str, np.ndarray]:
    """Map one RealNVP ``FlowChain``'s ``{"params": {"flows_{k}": ..}}`` to
    the port's ``FlowChain`` names, each prefixed with ``prefix``."""
    out: Dict[str, np.ndarray] = {}
    blocks = chain_variables["params"]
    for k in range(len(blocks)):
        for net, layers in blocks[f"flows_{k}"].items():
            _mlp(out, f"{prefix}flows.{k}.{net}.", layers)
    return {k: _f32(v) for k, v in out.items()}


def mlp_state_from_jax(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Map a three-layer MLP's ``{"Dense_{i}": ..}`` params (a
    ``TransitionMLP``'s, the particle encoder's, the likelihood head's) to
    ``{prefix}fc{i+1}``."""
    out: Dict[str, np.ndarray] = {}
    _mlp(out, prefix, params)
    return {k: _f32(v) for k, v in out.items()}


_FLOW_VECTORS = {flows.MAF: ("initial_param",), flows.NSFAutoregressive: ("init_param",),
                 flows.ActNorm: ("mu", "log_sigma"), flows.InvertibleLinear: ("L", "S", "U"),
                 flows.Planar: ("w", "u", "b"), flows.Radial: ("x0", "log_alpha", "beta")}
_FLOW_NETS = {flows.AffineCoupling: ("t1", "s1", "t2", "s2"), flows.NSFCoupling: ("f1", "f2")}


def _flow(out, flow, params, constants, prefix):
    if isinstance(flow, flows.FlowChain):
        for k, sub in enumerate(flow.flows):
            _flow(out, sub, params[f"flows_{k}"], (constants or {}).get(f"flows_{k}"),
                  f"{prefix}flows.{k}.")
        return
    kind = type(flow)
    if kind not in _FLOW_VECTORS and kind not in _FLOW_NETS:
        raise KeyError(f"bridge: no mapping for the flow {kind.__name__}")
    for name in _FLOW_VECTORS.get(kind, ()):
        out[prefix + name] = params[name]
    for net in _FLOW_NETS.get(kind, ()):
        _mlp(out, f"{prefix}{net}.", params[net])
    for i in range(len(getattr(flow, "layers", ()))):
        _mlp(out, f"{prefix}layers.{i}.", params[f"layers_{i}"])
    if kind is flows.InvertibleLinear and constants is not None:
        out[prefix + "P"] = constants["P"]


def flow_state_from_jax(flow, variables, prefix: str = "") -> Dict[str, np.ndarray]:
    """Map the flax ``variables`` (``{"params": .., "constants": ..}``, or a
    gradient tree as ``{"params": grads}``) of one flow or ``FlowChain`` to
    the names of the port's ``flow``, each prefixed with ``prefix``."""
    out: Dict[str, np.ndarray] = {}
    _flow(out, flow, variables["params"], variables.get("constants"), prefix)
    return {k: _f32(v) for k, v in out.items()}


def _cglow_conv(out, name, conv):
    out[f"{name}.conv.weight"] = _conv(conv["kernel"])
    if "bias" in conv:
        out[f"{name}.conv.bias"] = conv["bias"]


def _cglow_resize(out, name, conv):
    """A ``ConvResize``: its (kh, kw, I, O) kernel flattened to (kh·kw·I, O)."""
    out[f"{name}.conv.weight"] = np.reshape(conv["kernel"], (-1, conv["kernel"].shape[-1]))
    out[f"{name}.conv.bias"] = conv["bias"]


def _cglow_condnet(out, name, net):
    for i in range(3):
        _cglow_resize(out, f"{name}.resize.{i}", net[f"ConvResize_{i}"]["Conv_0"])
    head = net.get("DenseZeros_2", net.get("DenseNorm_0"))
    for i, layer in enumerate((net["DenseZeros_0"], net["DenseZeros_1"], head)):
        out[f"{name}.dense.{i}.weight"] = _dense_w(layer["Dense_0"]["kernel"])
        out[f"{name}.dense.{i}.bias"] = layer["Dense_0"]["bias"]


def cglow_state_from_jax(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Map a ``CondGlowModel``'s params to the port's names, each prefixed
    with ``prefix``; raises ``KeyError`` for an entry it has no mapping for."""
    out: Dict[str, np.ndarray] = {}
    for key, sub in params.items():
        if key in ("top_mean", "top_logs"):
            out[prefix + key] = sub
            continue
        if not key.startswith("layer_mods_"):
            raise KeyError(f"bridge: no mapping for the CGLOW entry {key!r}")
        name = f"{prefix}layer_mods.{key[len('layer_mods_'):]}"
        if set(sub) == {"prior_conv"}:
            _cglow_conv(out, f"{name}.prior_conv", sub["prior_conv"]["Conv_0"])
            continue
        if set(sub) != {"actnorm", "invconv", "affine"}:
            raise KeyError(f"bridge: no mapping for the CGLOW layer {key}: {sorted(sub)}")
        for net in ("actnorm", "invconv"):
            _cglow_condnet(out, f"{name}.{net}.net", sub[net]["net"])
        aff = sub["affine"]
        _cglow_resize(out, f"{name}.affine.rx2", aff["rx2"]["Conv_0"])
        for conv in ("rx1", "rx3", "f1", "f2", "f3"):
            _cglow_conv(out, f"{name}.affine.{conv}", aff[conv]["Conv_0"])
        for conv in ("f1", "f2"):
            for p in ("bias", "logs"):
                out[f"{name}.affine.{conv}.actnorm.{p}"] = aff[conv]["ImageActNorm_0"][p]
        for p in ("logs", "newbias"):
            out[f"{name}.affine.f3.{p}"] = aff["f3"][p]
    return {k: _f32(v) for k, v in out.items()}


def torch_state_from_jax(variables) -> Dict[str, np.ndarray]:
    """Map a JAX ``variables`` (or gradient) pytree to the port's
    ``state_dict`` names and layouts.  Collections that are absent
    (e.g. ``batch_stats`` in a gradient tree) are left out."""
    out: Dict[str, np.ndarray] = {}
    enc = variables["encoder"]
    p, s = enc.get("params"), enc.get("batch_stats")
    for i in range(5):
        if p is not None:
            out[f"encoder.convs.{i}.weight"] = _conv(p[f"Conv_{i}"]["kernel"])
        _bn(out, "encoder", p, s, i)
    if p is not None:
        out["encoder.dense.weight"] = _dense_w(p["Dense_0"]["kernel"])
        out["encoder.dense.bias"] = p["Dense_0"]["bias"]

    dec = variables["decoder"]
    p, s = dec.get("params"), dec.get("batch_stats")
    for i in range(5):
        if p is not None:
            out[f"decoder.deconvs.{i}.weight"] = _deconv(p[f"ConvTranspose_{i}"]["kernel"])
        _bn(out, "decoder", p, s, i)
    if p is not None:
        out["decoder.dense.weight"] = _dense_w(p["Dense_0"]["kernel"])
        out["decoder.dense.bias"] = p["Dense_0"]["bias"]

    for chain in ("nf_dyn", "cond_model"):
        out.update(flow_chain_state_from_jax(variables[chain], prefix=f"{chain}."))

    meas = variables["measurement"]["params"]
    unknown = sorted(set(meas) - {"particle_encoder", "likelihood_net", "cnf", "cglow"})
    if unknown:
        raise KeyError(f"bridge: no mapping for the measurement's {unknown}")
    for net in ("particle_encoder", "likelihood_net"):
        if net in meas:
            _mlp(out, f"measurement.{net}.", meas[net])
    if "cnf" in meas:
        out.update(flow_chain_state_from_jax({"params": meas["cnf"]}, prefix="measurement.cnf."))
    if "cglow" in meas:
        out.update(cglow_state_from_jax(meas["cglow"], prefix="measurement.cglow."))
    return {k: _f32(v) for k, v in out.items()}


@torch.no_grad()
def load_jax_variables(engine: torch.nn.Module, variables, mesh=None) -> None:
    """Fill ``engine`` (a port ``DPF``) with the JAX ``variables``: every
    parameter and BN buffer of the port must be covered.  On a ``mesh``
    every rank calls this, and afterwards each holds the first rank's
    bits (``replicate``)."""
    state = torch_state_from_jax(variables)
    own = engine.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"bridge mismatch: missing {missing}, unexpected {extra}")
    for name, value in state.items():
        if tuple(own[name].shape) != value.shape:
            raise ValueError(f"{name}: port shape {tuple(own[name].shape)}, "
                             f"JAX shape {value.shape}")
        own[name].copy_(torch.tensor(value))
    replicate(engine, mesh)
