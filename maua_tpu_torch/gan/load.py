"""StyleGAN2 and StyleGAN3 checkpoint loading into the port's parameter dicts.

Port of `maua_tpu/gan/load.py` (load_torch_file, the tolerant NVIDIA
pickle reader, the rosinality remap, infer_config, params_from_state_dict,
load_network and the StyleGAN3 branch). Supported files:

* ADA-style flat state dicts: ``mapping.fc{i}.*``, ``synthesis.b{res}.*``
* inference-style ModuleList dicts: ``mapping.fcs.{i}.*``, ``synthesis.bs.{i}.*``
* rosinality StyleGAN2 dicts (``g_ema`` with ``style.*/convs.*/to_rgbs.*``)
* NVIDIA ``.pkl`` files (persistence-pickled modules), read without
  NVIDIA's ``torch_utils`` or ``dnnlib``
* alias-free (StyleGAN3) state dicts: ``synthesis.input.*``,
  ``synthesis.L{i}_{size}_{channels}.*``

The torch layout of these files is the port's own (conv OIHW, fc
(out, in), const (C, H, W)), so the tensors pass through unchanged apart
from squeezes and StyleGAN3's input mixing weight. Parameters come back
as f32 CPU tensors; the facades move them to their device.
"""

from __future__ import annotations

import io
import pickle
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .stylegan2 import SG2Config
from .stylegan3 import SG3Config


# ------------------------------------------------------- deserialization
def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """Load any supported checkpoint file into a flat {key: f32 ndarray}."""
    if str(path).endswith(".pkl"):
        sd = _load_nvidia_pickle(path)
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = _extract_state_dict(obj)
    return {k: _to_numpy(v) for k, v in sd.items() if _is_tensorlike(v)}


def _is_tensorlike(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def _extract_state_dict(obj):
    """Find the generator state dict inside assorted container formats."""
    if isinstance(obj, dict):
        for key in ("G_ema", "g_ema", "generator", "G", "state_dict"):
            if key in obj:
                inner = obj[key]
                if hasattr(inner, "state_dict"):
                    return inner.state_dict()
                if isinstance(inner, dict):
                    sd = dict(inner)
                    if "latent_avg" in obj:
                        sd["latent_avg"] = obj["latent_avg"]
                    return sd
        return obj
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    raise ValueError("unrecognized checkpoint container")


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickler that resolves NVIDIA persistence / dnnlib classes to
    stand-in containers, so the tensors can be read without NVIDIA's
    source tree.

    stylegan2-ada(-pytorch) pickles every network class through
    `torch_utils.persistence`: each module reduces to
    `_reconstruct_persistent_obj(meta)`, where meta is a dnnlib.EasyDict
    carrying the class source and `state`, the module's raw __dict__ (so
    tensors sit in `_parameters`/`_buffers` and submodules in `_modules`).
    That reconstructor resolves to one that rebuilds a plain attribute
    container from `state`, and every other missing class to a
    dict-subclass stub (EasyDict is a dict subclass, so its SETITEMS
    opcodes need a real dict underneath)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            if name == "_reconstruct_persistent_obj":
                return _reconstruct_persistent_obj
            return _make_stub(module, name)


_STUB_CACHE: Dict[Tuple[str, str], type] = {}


def _make_stub(module, name):
    key = (module, name)
    if key not in _STUB_CACHE:

        class Stub(dict):
            _module, _name = module, name

            def __init__(self, *a, **kw):
                super().__init__()

            def __setstate__(self, state):
                self.__dict__.update(state if isinstance(state, dict) else {"state": state})

        Stub.__name__ = name
        _STUB_CACHE[key] = Stub
    return _STUB_CACHE[key]


def _reconstruct_persistent_obj(meta):
    """Stand-in for torch_utils.persistence._reconstruct_persistent_obj:
    an attribute container rebuilt from the pickled module state (the
    embedded source code is ignored)."""
    obj = _make_stub("torch_utils.persistence", "PersistentObj")()
    state = None
    if isinstance(meta, dict):
        state = meta.get("state")
    if state is None and hasattr(meta, "__dict__"):
        state = meta.__dict__.get("state")
    if isinstance(state, dict):
        obj.__dict__.update(state)
    elif meta is not None:
        obj.__dict__["meta"] = meta
    return obj


def _load_nvidia_pickle(path: str, key: str = "G_ema"):
    """The tensors of one network (`key`) of an NVIDIA .pkl, by state-dict name."""
    with open(path, "rb") as f:
        data = f.read()
    obj = _TolerantUnpickler(io.BytesIO(data)).load()
    g = obj.get(key, obj) if isinstance(obj, dict) else obj
    # persistence-pickled modules carry their tensors in nested dicts whose
    # names follow nn.Module's _parameters / _buffers / _modules
    sd = {}

    def walk(prefix, node, depth=0):
        if depth > 64:
            return
        if isinstance(node, torch.Tensor):
            sd[prefix.rstrip(".")] = node
            return
        d = getattr(node, "__dict__", None) or {}
        for sub in ("_parameters", "_buffers"):
            for k, v in (d.get(sub) or {}).items():
                if isinstance(v, torch.Tensor) and isinstance(k, str):
                    sd[prefix + k] = v
        for k, v in (d.get("_modules") or {}).items():
            if v is not None and isinstance(k, str):
                walk(prefix + k + ".", v, depth + 1)
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(k, str) and not k.startswith("_"):
                    walk(prefix + k + ".", v, depth + 1)
        for k, v in d.items():
            if isinstance(k, str) and not k.startswith("_"):
                walk(prefix + k + ".", v, depth + 1)

    if hasattr(g, "state_dict"):
        return g.state_dict()
    walk("", g)
    return sd


# -------------------------------------------------------- key normalize
def _normalize_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Map inference-style ModuleList keys (fcs.{i} / bs.{i}) onto
    ADA-style names (fc{i} / b{res})."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"mapping\.fcs\.(\d+)\.", lambda m: f"mapping.fc{m.group(1)}.", k)
        k = re.sub(r"synthesis\.bs\.(\d+)\.", lambda m: f"synthesis.b{2 ** (2 + int(m.group(1)))}.", k)
        out[k] = v
    return out


def is_rosinality(sd: Dict[str, np.ndarray]) -> bool:
    return any(k.startswith("convs.") for k in sd) and any(k.startswith("style.") for k in sd)


def rosinality_to_ada(sd: Dict[str, np.ndarray], blur_scale: float = 4.0) -> Dict[str, np.ndarray]:
    """Rosinality-format key remap onto ADA names."""
    out = {}
    out["synthesis.b4.const"] = sd["input.input"].squeeze(0)
    out["synthesis.b4.conv1.noise_const"] = sd["noises.noise_0"].squeeze(0).squeeze(0)
    out["synthesis.b4.conv1.weight"] = sd["conv1.conv.weight"].squeeze(0)
    out["synthesis.b4.conv1.bias"] = sd["conv1.activate.bias"]
    out["synthesis.b4.conv1.affine.weight"] = sd["conv1.conv.modulation.weight"]
    out["synthesis.b4.conv1.affine.bias"] = sd["conv1.conv.modulation.bias"]
    out["synthesis.b4.conv1.noise_strength"] = sd["conv1.noise.weight"].squeeze(0)
    out["synthesis.b4.torgb.weight"] = sd["to_rgb1.conv.weight"].squeeze(0)
    out["synthesis.b4.torgb.bias"] = sd["to_rgb1.bias"].reshape(-1)
    out["synthesis.b4.torgb.affine.weight"] = sd["to_rgb1.conv.modulation.weight"]
    out["synthesis.b4.torgb.affine.bias"] = sd["to_rgb1.conv.modulation.bias"]

    for key, val in sd.items():
        if key.startswith("style."):
            _, num, wb = key.split(".")
            out[f"mapping.fc{int(num) - 1}.{wb}"] = val
        elif key.startswith("noises.") and key != "noises.noise_0":
            n = int(key.split("_")[1])
            r = 2 ** (3 + (n - 1) // 2)
            out[f"synthesis.b{r}.conv{(n - 1) % 2}.noise_const"] = val.squeeze(0).squeeze(0)
        elif key.startswith("convs."):
            n = int(key.split(".")[1])
            r = 2 ** (3 + n // 2)
            ros = ".".join(key.split(".")[2:])
            tgt = f"synthesis.b{r}.conv{n % 2}"
            if ros == "conv.weight":
                out[f"{tgt}.weight"] = val.squeeze(0)
            elif ros == "activate.bias":
                out[f"{tgt}.bias"] = val
            elif ros == "conv.modulation.weight":
                out[f"{tgt}.affine.weight"] = val
            elif ros == "conv.modulation.bias":
                out[f"{tgt}.affine.bias"] = val
            elif ros == "noise.weight":
                out[f"{tgt}.noise_strength"] = val.squeeze(0)
        elif key.startswith("to_rgbs."):
            n = int(key.split(".")[1])
            r = 2 ** (3 + n)
            ros = ".".join(key.split(".")[2:])
            tgt = f"synthesis.b{r}.torgb"
            if ros == "conv.weight":
                out[f"{tgt}.weight"] = val.squeeze(0)
            elif ros == "bias":
                out[f"{tgt}.bias"] = val.reshape(-1)
            elif ros == "conv.modulation.weight":
                out[f"{tgt}.affine.weight"] = val
            elif ros == "conv.modulation.bias":
                out[f"{tgt}.affine.bias"] = val
    if "latent_avg" in sd:
        out["mapping.w_avg"] = sd["latent_avg"]
    return out


# ------------------------------------------------------------ to params
def _tensor(a) -> torch.Tensor:
    """An f32 CPU tensor holding its own copy of `a`."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _fc(sd, prefix) -> Dict[str, torch.Tensor]:
    return {"w": _tensor(sd[f"{prefix}.weight"]), "b": _tensor(sd[f"{prefix}.bias"])}


def infer_config(sd: Dict[str, np.ndarray], dtype: str = "float32") -> SG2Config:
    """Derive an SG2Config from a normalized ADA-style state dict."""
    resolutions = set()
    for k in sd:
        m = re.match(r"synthesis\.b(\d+)\.", k)
        if m:
            resolutions.add(int(m.group(1)))
    img_resolution = max(resolutions)
    n_map = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"mapping\.fc(\d+)\.", k)))
    w_dim = sd["synthesis.b4.conv1.affine.weight"].shape[1]
    z_dim = sd["mapping.fc0.weight"].shape[1]
    img_channels = sd[f"synthesis.b{img_resolution}.torgb.bias"].shape[0]
    # the channel table from the conv weights: the first resolution below
    # channel_max recovers channel_base
    channel_max = sd["synthesis.b4.conv1.weight"].shape[0]
    channel_base = 32768
    for res in sorted(resolutions):
        co = sd[f"synthesis.b{res}.conv1.weight"].shape[0]
        if co < channel_max:
            channel_base = co * res
            break
    arch = "resnet" if any(".skip." in k for k in sd) else "skip"
    return SG2Config(
        z_dim=z_dim,
        c_dim=0,
        w_dim=w_dim,
        img_resolution=img_resolution,
        img_channels=img_channels,
        channel_base=channel_base,
        channel_max=channel_max,
        architecture=arch,
        mapping_layers=n_map,
        dtype=dtype,
    )


def params_from_state_dict(sd: Dict[str, np.ndarray], cfg: Optional[SG2Config] = None) -> Dict:
    """ADA-style state dict -> the port's StyleGAN2 parameter dict. A
    missing noise_strength defaults to 1 (an inference net that adds its
    noise unscaled), a missing noise_const to zeros."""
    sd = _normalize_keys(sd)
    if cfg is None:
        cfg = infer_config(sd)

    mapping = {f"fc{i}": _fc(sd, f"mapping.fc{i}") for i in range(cfg.mapping_layers)}
    if cfg.c_dim > 0:
        mapping["embed"] = _fc(sd, "mapping.embed")
    mapping["w_avg"] = _tensor(sd.get("mapping.w_avg", np.zeros(cfg.w_dim, np.float32)))

    def conv_layer(prefix, res):
        p = {"affine": _fc(sd, f"{prefix}.affine"), "weight": _tensor(sd[f"{prefix}.weight"]),
             "bias": _tensor(sd[f"{prefix}.bias"])}
        p["noise_const"] = _tensor(sd.get(f"{prefix}.noise_const", np.zeros((res, res), np.float32)))
        p["noise_strength"] = _tensor(np.asarray(sd.get(f"{prefix}.noise_strength", np.ones((), np.float32))).reshape(()))
        return p

    synthesis = {}
    for res in cfg.block_resolutions:
        b = f"synthesis.b{res}"
        block = {}
        if res == 4:
            block["const"] = _tensor(sd[f"{b}.const"])
        else:
            block["conv0"] = conv_layer(f"{b}.conv0", res)
            if f"{b}.skip.weight" in sd:
                block["skip"] = {"weight": _tensor(sd[f"{b}.skip.weight"])}
        block["conv1"] = conv_layer(f"{b}.conv1", res)
        if f"{b}.torgb.weight" in sd:
            block["torgb"] = {"affine": _fc(sd, f"{b}.torgb.affine"), "weight": _tensor(sd[f"{b}.torgb.weight"]),
                              "bias": _tensor(sd[f"{b}.torgb.bias"])}
        synthesis[f"b{res}"] = block
    return {"mapping": mapping, "synthesis": synthesis}


def load_network(path: str, dtype: str = "float32"):
    """Load a StyleGAN2 or StyleGAN3 generator from any supported file.

    Returns (params, cfg): f32 CPU tensors in the port's layout, and an
    SG2Config or SG3Config whose compute dtype is `dtype`."""
    sd = load_torch_file(path)
    if is_rosinality(sd):
        sd = rosinality_to_ada(sd)
    sd = _normalize_keys(sd)
    if is_stylegan3(sd):
        cfg = infer_sg3_config(sd, dtype=dtype)
        return sg3_params_from_state_dict(sd, cfg), cfg
    cfg = infer_config(sd, dtype=dtype)
    return params_from_state_dict(sd, cfg), cfg


# ------------------------------------------------------------- StyleGAN3
def is_stylegan3(sd: Dict[str, np.ndarray]) -> bool:
    """Alias-free checkpoints carry the Fourier input and the
    L{i}_{size}_{channels} layer names (NVIDIA's StyleGAN3 module naming)."""
    return any(k.startswith(("synthesis.input.", "input.")) for k in sd) and any(
        ".freqs" in k or k == "synthesis.input.freqs" for k in sd
    )


def infer_sg3_config(sd: Dict[str, np.ndarray], dtype: str = "float32") -> SG3Config:
    """Infer an SG3Config from an alias-free state dict. The layer names
    `synthesis.L{i}_{size}_{channels}` give the count and the output
    resolution; the kernel size tells the -T (3x3) and -R (1x1) configs apart."""
    layers = {}
    for k in sd:
        m = re.match(r"synthesis\.L(\d+)_(\d+)_(\d+)\.weight$", k)
        if m:
            layers[int(m.group(1))] = (int(m.group(2)), int(m.group(3)), sd[k])
    if not layers:
        raise ValueError("no synthesis.L* layers found — not an SG3 state dict")
    n = max(layers) + 1
    img_resolution = layers[max(layers)][0]
    conv_kernel = layers[0][2].shape[-1]
    z_dim = sd["mapping.fc0.weight"].shape[1]
    w_dim = sd["mapping.fc0.weight"].shape[0]
    mapping_layers = len([k for k in sd if re.match(r"mapping\.fc\d+\.weight$", k)])
    cmax = max(v[1] for v in layers.values())
    observed = [layers[i][1] for i in sorted(layers)]
    observed_sizes = [layers[i][0] for i in sorted(layers)]
    # search (channel_base, margin_size) whose layer plan reproduces both the
    # channel counts and the canvas sizes of the layer names (the -T/-R
    # configs differ in channels; margin_size sets every intermediate canvas)
    for cb in (32768, 65536, 16384, 8192, 4096, 2048, 1024, 512):
        for margin in (10, 4, 6, 8, 12, 16, 2):
            cand = SG3Config(
                z_dim=z_dim, w_dim=w_dim, img_resolution=img_resolution, num_layers=n,
                mapping_layers=mapping_layers, conv_kernel=conv_kernel,
                channel_base=cb, channel_max=cmax, margin_size=margin, dtype=dtype,
            )
            _, _, _, _, sizes_p, chans_p = cand.layer_plan()
            if [int(c) for c in chans_p[1:]] == observed and [int(s) for s in sizes_p[1:]] == observed_sizes:
                return cand
    raise ValueError(
        f"could not infer SG3 channel_base for observed channels {observed}; "
        "pass an explicit SG3Config to sg3_params_from_state_dict"
    )


def sg3_params_from_state_dict(sd: Dict[str, np.ndarray], cfg: Optional[SG3Config] = None) -> Dict:
    """Alias-free state dict (NVIDIA names: mapping.fc*, synthesis.input.*,
    synthesis.L{i}_{size}_{ch}.*) -> the port's StyleGAN3 parameter dict."""
    sd = _normalize_keys(sd)
    if cfg is None:
        cfg = infer_sg3_config(sd)

    mapping = {f"fc{i}": _fc(sd, f"mapping.fc{i}") for i in range(cfg.mapping_layers)}
    mapping["w_avg"] = _tensor(sd.get("mapping.w_avg", np.zeros(cfg.w_dim, np.float32)))

    raw = sd["synthesis.input.weight"]
    input_p = {
        "freqs": _tensor(sd["synthesis.input.freqs"]),
        "phases": _tensor(sd["synthesis.input.phases"]),
        "affine": _fc(sd, "synthesis.input.affine"),
        # NVIDIA stores the 1x1 mixing conv as (co, ci) raw and divides by
        # sqrt(channels) at run time; synthesis applies no gain, so the
        # division is baked in here, with numpy's arithmetic as maua_tpu does it
        "weight": _tensor(raw[:, :, None, None] / np.sqrt(raw.shape[1])),
        "transform": _tensor(sd.get("synthesis.input.transform", np.eye(3, dtype=np.float32))),
    }

    names = {}
    for k in sd:
        m = re.match(r"synthesis\.(L(\d+)_\d+_\d+)\.weight$", k)
        if m:
            names[int(m.group(2))] = m.group(1)
    layers = []
    for i in range(cfg.num_layers):
        p = f"synthesis.{names[i]}"
        layers.append({
            "affine": _fc(sd, f"{p}.affine"),
            "weight": _tensor(sd[f"{p}.weight"]),
            "bias": _tensor(sd[f"{p}.bias"]),
            "magnitude_ema": _tensor(np.asarray(sd.get(f"{p}.magnitude_ema", np.ones((), np.float32))).reshape(())),
        })
    return {"mapping": mapping, "input": input_p, "layers": layers}


# --------------------------------------------------------- discriminator
def infer_d_config(sd: Dict[str, np.ndarray], dtype: str = "float32"):
    """A D2Config from an ADA-style discriminator state dict (shapes only)."""
    from .discriminator import D2Config

    res_list = sorted({int(m.group(1)) for k in sd for m in [re.match(r"b(\d+)\.conv0\.weight$", k)] if m})
    if not res_list:
        raise ValueError("state dict has no b{res}.conv0 keys - not an ADA discriminator")
    top = max(res_list)
    ch_in = {res: sd[f"b{res}.conv0.weight"].shape[1] for res in res_list}  # OIHW in-channels
    c4 = sd["b4.fc.weight"].shape[0]
    cmax = max(max(ch_in.values()), c4)
    uncapped = [ch_in[r] * r for r in res_list if ch_in[r] < cmax]
    channel_base = max(uncapped) if uncapped else cmax * top
    mbstd_num = int(sd["b4.conv.weight"].shape[1] - c4)
    img_channels = int(sd[f"b{top}.fromrgb.weight"].shape[1]) if f"b{top}.fromrgb.weight" in sd else 3
    return D2Config(img_resolution=top, img_channels=img_channels, channel_base=int(channel_base),
                    channel_max=int(cmax), mbstd_num_channels=mbstd_num, dtype=dtype)


def d_params_from_state_dict(sd: Dict[str, np.ndarray], cfg=None) -> Dict:
    """ADA discriminator state dict -> the port's parameter dict. The layouts are the port's own
    (conv OIHW, fc (out, in), the b4 FC over the (C, H, W) flatten), so the tensors pass unchanged;
    both sides apply the equalized-lr gains at run time."""
    cfg = cfg or infer_d_config(sd)
    top = cfg.img_resolution
    params = {"fromrgb": {"weight": _tensor(sd[f"b{top}.fromrgb.weight"]),
                          "bias": _tensor(sd[f"b{top}.fromrgb.bias"])}}
    for res in cfg.block_resolutions:
        params[f"b{res}"] = {
            **{c: {"weight": _tensor(sd[f"b{res}.{c}.weight"]), "bias": _tensor(sd[f"b{res}.{c}.bias"])}
               for c in ("conv0", "conv1")},
            "skip": {"weight": _tensor(sd[f"b{res}.skip.weight"])},
        }
    params["b4"] = {"conv": {"weight": _tensor(sd["b4.conv.weight"]), "bias": _tensor(sd["b4.conv.bias"])},
                    "fc": _fc(sd, "b4.fc"), "out": _fc(sd, "b4.out")}
    return params


def load_discriminator(path: str, dtype: str = "float32"):
    """The discriminator of a StyleGAN training checkpoint: an NVIDIA .pkl's `D`, a .pt dict's
    `D` / `d` / `discriminator` / `D_ema` entry, or a bare ADA D state dict. Returns (params, D2Config),
    f32 CPU tensors."""
    if str(path).endswith(".pkl"):
        sd = _load_nvidia_pickle(path, key="D")
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = None
        if isinstance(obj, dict):
            for key in ("D", "d", "discriminator", "D_ema"):
                if key in obj:
                    inner = obj[key]
                    sd = inner.state_dict() if hasattr(inner, "state_dict") else dict(inner)
                    break
            if sd is None:
                sd = obj  # maybe a bare D state dict
        elif hasattr(obj, "state_dict"):
            sd = obj.state_dict()
        else:
            raise ValueError(f"no discriminator found in {path}")
    sd = {k: _to_numpy(v) for k, v in sd.items() if _is_tensorlike(v)}
    if not any(k.startswith("b4.out") for k in sd):
        raise ValueError(f"no ADA-style discriminator state dict found in {path}")
    cfg = infer_d_config(sd, dtype=dtype)
    return d_params_from_state_dict(sd, cfg), cfg
