"""The port's diffusion family (``deepspeed_tpu_torch/models/diffusion.py``,
``module_inject/diffusion_policies.py``, ``init_diffusion``) against the
JAX package, on the same weights and inputs.

Inputs come from numpy seeds; module weights from the JAX ``init`` cross
with ``to_torch_tree`` (the same HWIO/``[in, out]`` layout).  The models
are the JAX suite's narrow ones: a UNet of two levels (32 and 64
channels, one layer a block, 2 heads, cross-attention width 24, 8
groups), a VAE of 16 and 32 channels and a CLIP tower of 2 layers at
width 24, all in float32.  Values agree within 1e-5 (atol and rtol: the
same f32 math in another order of sums); loaders give the JAX loaders'
trees exactly.  HF-named state dicts are synthesised from the JAX init
trees by the exporters below, so a loader round trip gives the tree
back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import diffusion as jd
from deepspeed_tpu.module_inject import diffusion_policies as jpol
from deepspeed_tpu_torch.models import diffusion as td
from deepspeed_tpu_torch.module_inject import diffusion_policies as tpol

TOL = dict(atol=1e-5, rtol=1e-5)

UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
            cross_attention_dim=24, attention_head_dim=2,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            norm_num_groups=8, sample_size=8)
VAE = dict(block_out_channels=(16, 32), layers_per_block=1,
           norm_num_groups=8)
CLIP = dict(vocab_size=64, hidden_size=24, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=8)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def jx(a):
    return jnp.asarray(a)


def tt(a):
    return torch.from_numpy(np.array(a))


def nchw(x):
    return tt(x).permute(0, 3, 1, 2)


def flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, path + (i,))
    else:
        yield path, tree


def assert_trees_equal(got, want, **tol):
    g, w = dict(flat(got)), dict(flat(want))
    assert set(g) == set(w)
    for path in w:
        a = g[path].float().numpy() if isinstance(g[path], torch.Tensor) \
            else np.asarray(g[path])
        b = np.asarray(w[path], np.float32)
        assert a.shape == b.shape, path
        if tol:
            np.testing.assert_allclose(a, b, err_msg=str(path), **tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))


# -- primitives --------------------------------------------------------------
@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, "SAME"), (3, 2, "SAME"), (1, 1, "SAME"), (3, 2, "VALID")])
def test_conv_matches_jax(k, stride, padding):
    """HWIO kernels, symmetric padding under a stride; the raw kernel
    and the prepared OIHW weight give the same values."""
    p = {"kernel": rand(k, k, 6, 10, seed=1, scale=0.3),
         "bias": rand(10, seed=2)}
    x = rand(2, 9, 9, 6, seed=3)
    want = np.asarray(jd.conv_apply({n: jx(v) for n, v in p.items()},
                                    jx(x), stride, padding))
    tp = {n: tt(v) for n, v in p.items()}
    for params in (tp, td.prepare(tp, "cpu", torch.float32)):
        got = td.conv_apply(params, nchw(x), stride, padding)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   **TOL)


@pytest.mark.parametrize("groups,eps", [(4, 1e-5), (8, 1e-6), (32, 1e-5)])
def test_groupnorm_silu_timestep_and_attention_match_jax(groups, eps):
    """GroupNorm in f32 (groups capped at the channels), SiLU, the
    timestep embedding (even and odd widths) and ``_attn``."""
    p = {"scale": rand(16, seed=4), "bias": rand(16, seed=5)}
    x = rand(2, 5, 5, 16, seed=6, scale=3.0)
    want = jd.groupnorm_apply({n: jx(v) for n, v in p.items()}, jx(x),
                              groups, eps)
    got = td.groupnorm_apply({n: tt(v) for n, v in p.items()}, nchw(x),
                             groups, eps)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)
    np.testing.assert_allclose(td.silu(tt(x)).numpy(),
                               np.asarray(jd.silu(jx(x))), **TOL)
    t = np.array([0, 1, 500, 999], np.int32)
    for dim in (32, 33):
        np.testing.assert_allclose(
            td.timestep_embedding(tt(t), dim).numpy(),
            np.asarray(jd.timestep_embedding(jx(t), dim)), **TOL)
    q, k, v = (rand(2, 7, 12, seed=s) for s in (7, 8, 9))
    kv = rand(2, 5, 12, seed=10)
    np.testing.assert_allclose(
        td._attn(tt(q), tt(kv), tt(kv), 3).numpy(),
        np.asarray(jd._attn(jx(q), jx(kv), jx(kv), 3)), **TOL)
    np.testing.assert_allclose(
        td._attn(tt(q), tt(k), tt(v), 2).numpy(),
        np.asarray(jd._attn(jx(q), jx(k), jx(v), 2)), **TOL)


# -- modules -------------------------------------------------------------------
@pytest.fixture(scope="module")
def modules():
    """(JAX module, port module, JAX init params, the same as tensors)
    for the UNet, the VAE and CLIP."""
    out = {}
    for name, jcls, jcfg, tcls, tcfg, kw, seed in (
            ("unet", jd.UNet2DCondition, jd.UNetConfig, td.UNet2DCondition,
             td.UNetConfig, UNET, 0),
            ("vae", jd.AutoencoderKL, jd.VAEConfig, td.AutoencoderKL,
             td.VAEConfig, VAE, 1),
            ("text_encoder", jd.CLIPTextEncoder, jd.CLIPTextConfig,
             td.CLIPTextEncoder, td.CLIPTextConfig, CLIP, 2)):
        jm, tm = jcls(jcfg(**kw)), tcls(tcfg(**kw))
        jp = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
        out[name] = (jm, tm, jp, td.to_torch_tree(jp))
    return out


def test_unet_matches_jax(modules):
    """The whole UNet (resnets with the time embedding, cross-attention
    transformers, strided down and nearest up convs, the skips) on the
    raw and the prepared params."""
    jm, tm, jp, tp = modules["unet"]
    x = rand(2, 8, 8, 4, seed=11)
    ctx = rand(2, 5, 24, seed=12)
    t = np.array([3, 700], np.int32)
    want = np.asarray(jm.apply(jp, jx(x), jx(t), jx(ctx)))
    for params in (tp, td.prepare(tp, "cpu", torch.float32)):
        got = tm.apply(params, tt(x), tt(t), tt(ctx))
        assert tuple(got.shape) == (2, 8, 8, 4)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vae_encode_decode_match_jax(modules):
    jm, tm, jp, tp = modules["vae"]
    img = rand(1, 16, 16, 3, seed=13)
    jmean, jlogvar = jm.encode(jp, jx(img))
    mean, logvar = tm.encode(tp, tt(img))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), **TOL)
    z = rand(1, 8, 8, 4, seed=14)
    np.testing.assert_allclose(tm.decode(tp, tt(z)).numpy(),
                               np.asarray(jm.decode(jp, jx(z))), **TOL)


def test_clip_matches_jax(modules):
    jm, tm, jp, tp = modules["text_encoder"]
    ids = np.random.RandomState(15).randint(0, 64, (2, 8)).astype(np.int32)
    np.testing.assert_allclose(tm.apply(tp, tt(ids).long()).numpy(),
                               np.asarray(jm.apply(jp, jx(ids))), **TOL)


def test_port_inits_build_the_jax_trees():
    """Each port ``init`` gives the JAX init's paths and shapes."""
    for jcls, jcfg, tcls, tcfg, kw in (
            (jd.UNet2DCondition, jd.UNetConfig, td.UNet2DCondition,
             td.UNetConfig, UNET),
            (jd.AutoencoderKL, jd.VAEConfig, td.AutoencoderKL, td.VAEConfig,
             VAE),
            (jd.CLIPTextEncoder, jd.CLIPTextConfig, td.CLIPTextEncoder,
             td.CLIPTextConfig, CLIP)):
        want = {p: tuple(np.shape(v)) for p, v in flat(jax.device_get(
            jcls(jcfg(**kw)).init(jax.random.PRNGKey(0))))}
        got = {p: tuple(v.shape) for p, v in flat(
            tcls(tcfg(**kw)).init(torch.Generator().manual_seed(0)))}
        assert got == want


# -- schedulers and the pipeline ----------------------------------------------
@pytest.mark.parametrize("offset,one", [(1, False), (0, True)])
def test_schedulers_match_jax(offset, one):
    """DDIM and Euler: their numpy tables, timesteps and steps (the last
    step too, to alphas_cumprod[0] or 1), Euler's input scaling."""
    cfg = dict(steps_offset=offset, set_alpha_to_one=one)
    eps, x = rand(1, 4, 4, 4, seed=16), rand(1, 4, 4, 4, seed=17)
    for jcls, tcls in ((jd.DDIMScheduler, td.DDIMScheduler),
                       (jd.EulerDiscreteScheduler,
                        td.EulerDiscreteScheduler)):
        js, ts = jcls(jd.DDIMConfig(**cfg)), tcls(td.DDIMConfig(**cfg))
        np.testing.assert_array_equal(ts.alphas_cumprod,
                                      np.asarray(js.alphas_cumprod))
        np.testing.assert_array_equal(ts.timesteps(20), js.timesteps(20))
        for t, t_prev in ((981, 931), (21, 1), (1, -1)):
            np.testing.assert_allclose(
                ts.step(tt(eps), t, t_prev, tt(x)).numpy(),
                np.asarray(js.step(jx(eps), t, t_prev, jx(x))), **TOL)
            np.testing.assert_allclose(
                ts.scale_model_input(tt(x), t).numpy(),
                np.asarray(js.scale_model_input(jx(x), t)), **TOL)
        assert ts.init_noise_sigma(981) == pytest.approx(
            float(js.init_noise_sigma(981)), rel=1e-6)


@pytest.mark.parametrize("sched", ["ddim", "euler"])
def test_pipeline_with_latents_matches_jax(modules, sched):
    """The pipeline with latents given: CLIP on ``[uncond, text]``, three
    guided UNet steps, the VAE decode and the clip to [0, 1], against the
    JAX pipeline on the same params; another prompt changes the image."""
    jp = {k: v[2] for k, v in modules.items()}
    tp = {k: v[3] for k, v in modules.items()}
    jsch, tsch = ((jd.DDIMScheduler(), td.DDIMScheduler()) if sched == "ddim"
                  else (jd.EulerDiscreteScheduler(),
                        td.EulerDiscreteScheduler()))
    jpipe = jd.StableDiffusionPipeline(*(modules[k][0] for k in (
        "unet", "vae", "text_encoder")), scheduler=jsch)
    tpipe = td.StableDiffusionPipeline(*(modules[k][1] for k in (
        "unet", "vae", "text_encoder")), scheduler=tsch)
    ids = np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    un = np.zeros_like(ids)
    lat = rand(1, 4, 4, 4, seed=18)
    want = np.asarray(jpipe(jp, ids, un, num_steps=3, latents=jx(lat)))
    got = tpipe(tp, ids, un, num_steps=3, latents=tt(lat))
    assert tuple(got.shape) == (1, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    other = tpipe(tp, ids * 0 + 9, un, num_steps=3, latents=tt(lat))
    assert float((other - got).abs().max()) > 1e-6


# -- loaders -----------------------------------------------------------------
def _put_conv(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _put_lin(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _put_norm(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _put_resnet(sd, name, p):
    _put_norm(sd, f"{name}.norm1", p["norm1"])
    _put_conv(sd, f"{name}.conv1", p["conv1"])
    _put_norm(sd, f"{name}.norm2", p["norm2"])
    _put_conv(sd, f"{name}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _put_lin(sd, f"{name}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _put_conv(sd, f"{name}.conv_shortcut", p["conv_shortcut"])


def _put_t2d(sd, name, p):
    _put_norm(sd, f"{name}.norm", p["norm"])
    _put_conv(sd, f"{name}.proj_in", p["proj_in"])
    _put_conv(sd, f"{name}.proj_out", p["proj_out"])
    for k, bp in enumerate(p["blocks"]):
        b = f"{name}.transformer_blocks.{k}"
        for n in ("norm1", "norm2", "norm3"):
            _put_norm(sd, f"{b}.{n}", bp[n])
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _put_lin(sd, f"{b}.{a}.{n}", bp[a][n])
            _put_lin(sd, f"{b}.{a}.to_out.0", bp[a]["to_out"])
        _put_lin(sd, f"{b}.ff.net.0.proj", bp["ff"]["proj_in"])
        _put_lin(sd, f"{b}.ff.net.2", bp["ff"]["proj_out"])


def unet_state_dict(p):
    """diffusers names for a UNet params tree."""
    sd = {}
    _put_conv(sd, "conv_in", p["conv_in"])
    for n in ("linear_1", "linear_2"):
        _put_lin(sd, f"time_embedding.{n}", p["time_embedding"][n])
    for side, key in (("down_blocks", "downsample"),
                      ("up_blocks", "upsample")):
        for bi, blk in enumerate(p[side]):
            for li, rp in enumerate(blk["resnets"]):
                _put_resnet(sd, f"{side}.{bi}.resnets.{li}", rp)
            for li, ap in enumerate(blk["attentions"]):
                _put_t2d(sd, f"{side}.{bi}.attentions.{li}", ap)
            if key in blk:
                _put_conv(sd, f"{side}.{bi}.{key}rs.0.conv", blk[key])
    for li, rp in enumerate(p["mid_block"]["resnets"]):
        _put_resnet(sd, f"mid_block.resnets.{li}", rp)
    _put_t2d(sd, "mid_block.attentions.0", p["mid_block"]["attentions"][0])
    _put_norm(sd, "conv_norm_out", p["conv_norm_out"])
    _put_conv(sd, "conv_out", p["conv_out"])
    return sd


def vae_state_dict(p, legacy):
    """diffusers names for a VAE params tree (``legacy``: the
    pre-refactor attention names with 1x1-conv weights)."""
    sd = {}

    def mid(name, m):
        for li, rp in enumerate(m["resnets"]):
            _put_resnet(sd, f"{name}.resnets.{li}", rp)
        a = m["attentions"][0]
        _put_norm(sd, f"{name}.attentions.0.group_norm", a["group_norm"])
        names = (("query", "key", "value", "proj_attn") if legacy
                 else ("to_q", "to_k", "to_v", "to_out.0"))
        for src, dst in zip(("to_q", "to_k", "to_v", "to_out"), names):
            w = np.asarray(a[src]["kernel"]).T
            sd[f"{name}.attentions.0.{dst}.weight"] = (
                w[:, :, None, None] if legacy else w)
            sd[f"{name}.attentions.0.{dst}.bias"] = np.asarray(
                a[src]["bias"])
    for part, side, key in (("encoder", "down_blocks", "downsample"),
                            ("decoder", "up_blocks", "upsample")):
        e = p[part]
        _put_conv(sd, f"{part}.conv_in", e["conv_in"])
        for bi, blk in enumerate(e[side]):
            for li, rp in enumerate(blk["resnets"]):
                _put_resnet(sd, f"{part}.{side}.{bi}.resnets.{li}", rp)
            if key in blk:
                _put_conv(sd, f"{part}.{side}.{bi}.{key}rs.0.conv",
                          blk[key])
        mid(f"{part}.mid_block", e["mid_block"])
        _put_norm(sd, f"{part}.conv_norm_out", e["conv_norm_out"])
        _put_conv(sd, f"{part}.conv_out", e["conv_out"])
    _put_conv(sd, "quant_conv", p["quant_conv"])
    _put_conv(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


def clip_state_dict(p, prefix):
    """transformers names for a CLIP text tree (``prefix`` "" or
    "text_model."), with the ``position_ids`` buffer the loader skips."""
    sd = {f"{prefix}embeddings.token_embedding.weight":
          np.asarray(p["token_embedding"]["embedding"]),
          f"{prefix}embeddings.position_embedding.weight":
          np.asarray(p["position_embedding"]["embedding"]),
          f"{prefix}embeddings.position_ids": np.arange(8)[None]}
    _put_norm(sd, f"{prefix}final_layer_norm", p["final_layer_norm"])
    for i, lp in enumerate(p["layers"]):
        b = f"{prefix}encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            _put_norm(sd, f"{b}.{n}", lp[n])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put_lin(sd, f"{b}.self_attn.{n}", lp[n])
        for n in ("fc1", "fc2"):
            _put_lin(sd, f"{b}.mlp.{n}", lp[n])
    return sd


#: case → (module, state dict of its params, loader, config, widths)
LOADERS = {
    "unet": ("unet", unet_state_dict, "load_unet", "UNetConfig", UNET),
    "vae": ("vae", lambda p: vae_state_dict(p, False), "load_vae",
            "VAEConfig", VAE),
    "vae-legacy": ("vae", lambda p: vae_state_dict(p, True), "load_vae",
                   "VAEConfig", VAE),
    "clip": ("text_encoder", lambda p: clip_state_dict(p, ""),
             "load_clip_text", "CLIPTextConfig", CLIP),
    "clip-prefixed": ("text_encoder",
                      lambda p: clip_state_dict(p, "text_model."),
                      "load_clip_text", "CLIPTextConfig", CLIP),
}


def _sd_of(modules, case):
    """(state dict, loader name, config name, widths, the JAX tree)."""
    key, make, fn, cfg, kw = LOADERS[case]
    return make(modules[key][2]), fn, cfg, kw, modules[key][2]


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loaders_round_trip_as_jax(modules, case):
    """A synthetic HF state dict of the JAX init tree loads back to that
    tree exactly, as the JAX loader loads it; torch tensors (bf16 among
    them) load too, keeping their dtype."""
    sd, fn, cfg, kw, want = _sd_of(modules, case)
    got = getattr(tpol, fn)(getattr(td, cfg)(**kw), sd)
    assert_trees_equal(got, want)
    assert_trees_equal(got, getattr(jpol, fn)(getattr(jd, cfg)(**kw), sd))
    tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    name = sorted(k for k in tsd if "position_ids" not in k)[0]
    tsd[name] = tsd[name].to(torch.bfloat16)
    loaded = dict(flat(getattr(tpol, fn)(getattr(td, cfg)(**kw), tsd)))
    assert sum(v.dtype == torch.bfloat16 for v in loaded.values()) == 1


@pytest.mark.parametrize("case", ["unet", "vae", "clip"])
def test_loaders_refuse_partial_and_unconsumed_checkpoints(modules, case):
    """A missing key raises ``KeyError`` naming it; an extra key raises
    ``ValueError`` (not consumed), as the JAX loaders do."""
    sd, fn, cfg, kw, _ = _sd_of(modules, case)
    conf = getattr(td, cfg)(**kw)
    missing = dict(sd)
    gone = sorted(missing)[len(missing) // 2]
    missing.pop(gone)
    with pytest.raises(KeyError, match="missing"):
        getattr(tpol, fn)(conf, missing)
    extra = {**sd, "mystery.block.weight": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        getattr(tpol, fn)(conf, extra)
    with pytest.raises(ValueError, match="not consumed"):
        getattr(jpol, fn)(getattr(jd, cfg)(**kw), extra)


# -- init_diffusion -------------------------------------------------------------
def test_init_diffusion_loads_fills_and_runs(modules):
    """``init_diffusion`` on the CPU: the UNet from its state dict, the
    VAE from JAX-layout params, CLIP from a seeded init; the returned
    params are prepared (OIHW conv weights); the pipeline runs 2 DDIM
    steps to a finite image in [0, 1]; unknown state dict names and the
    default device without a card raise."""
    jp = {k: v[2] for k, v in modules.items()}
    pipe, params = dt.init_diffusion(
        td.UNetConfig(**UNET), td.VAEConfig(**VAE), td.CLIPTextConfig(**CLIP),
        state_dicts={"unet": unet_state_dict(jp["unet"])},
        params={"vae": jp["vae"]}, device="cpu")
    assert params["unet"]["conv_in"]["weight"].shape == (32, 4, 3, 3)
    assert "kernel" not in params["vae"]["quant_conv"]
    np.testing.assert_array_equal(
        params["vae"]["decoder"]["conv_in"]["weight"].numpy(),
        np.asarray(jp["vae"]["decoder"]["conv_in"]["kernel"]).transpose(
            3, 2, 0, 1))
    ids = np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    img = pipe(params, ids, np.zeros_like(ids), num_steps=2,
               generator=torch.Generator().manual_seed(3))
    assert tuple(img.shape) == (1, 16, 16, 3)
    assert bool(torch.isfinite(img).all())
    assert float(img.min()) >= 0 and float(img.max()) <= 1
    with pytest.raises(ValueError, match="unknown state_dicts"):
        dt.init_diffusion(state_dicts={"controlnet": {}}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dt.init_diffusion(td.UNetConfig(**UNET), td.VAEConfig(**VAE),
                              td.CLIPTextConfig(**CLIP))
