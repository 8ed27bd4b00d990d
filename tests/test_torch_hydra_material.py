"""HnMaterialNetwork in the port (diligentfx_tpu_torch/hydrogent/
material_network.py) against the JAX package's: every case of
tests/test_material_network.py, with the port's parse (parameters, texture
descriptors, slots, typed surface values, tag) and `normalized_payload`
held equal to JAX's, exactly.  The two end-to-end cases (the UV transform
tiles a texture, clamp against repeat outside [0, 1]) render through the
port's delegate on the CPU at 128 x 128 and check the same properties."""
import math

import numpy as np
import pytest
import torch

from diligentfx_tpu.hydrogent import material_network as jmn
from diligentfx_tpu.ops.sampling import (WRAP_CLAMP as J_CLAMP,
                                         WRAP_MIRROR as J_MIRROR,
                                         WRAP_REPEAT as J_REPEAT)
from diligentfx_tpu_torch.hydrogent import material_network as tmn
from diligentfx_tpu_torch.ops.sampling import (WRAP_CLAMP, WRAP_MIRROR,
                                               WRAP_REPEAT)
from tests.test_material_network import _checker, graph_net
from tests.torch_hydra_ref import small_port_renderer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif callable(a) or callable(b):
        np.testing.assert_array_equal(np.asarray(a()), np.asarray(b()))
    else:
        assert a == b, (a, b)


def assert_same_network(t, j):
    """The port's parse equals the JAX package's, field by field."""
    assert [p.type for p in t.parameters] == [p.type for p in j.parameters]
    for p, q in zip(t.parameters, j.parameters):
        for f in ("name", "sampler_coords", "swizzle", "input_scale",
                  "input_bias"):
            assert getattr(p, f) == getattr(q, f), f
        _same_value(p.fallback_value, q.fallback_value)
        assert (p.transform2d is None) == (q.transform2d is None)
        if p.transform2d is not None:
            assert (p.transform2d.as_scale_rot_bias()
                    == q.transform2d.as_scale_rot_bias())
    assert sorted(t.textures) == sorted(j.textures)
    for name in t.textures:
        assert_same_descriptor(t.textures[name], j.textures[name])
    for slot in range(5):
        a, b = t.texture_for_slot(slot), j.texture_for_slot(slot)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.name == b.name
            _same_value(tmn.normalized_payload(a, slot),
                        jmn.normalized_payload(b, slot))
    for f in ("diffuse_color", "metallic", "roughness", "emissive_color",
              "opacity", "opacity_threshold", "ior", "clearcoat",
              "clearcoat_roughness", "normal_scale", "tag"):
        assert getattr(t, f) == getattr(j, f), f
    assert sorted(t.texture_payloads) == sorted(j.texture_payloads)


def assert_same_descriptor(a, b):
    for f in ("name", "wrap_u", "wrap_v", "uv_transform", "primvar",
              "fallback", "swizzle", "input_scale", "input_bias"):
        assert getattr(a, f) == getattr(b, f), f
    _same_value(a.payload, b.payload)


def both(net):
    return tmn.HnMaterialNetwork(net), jmn.HnMaterialNetwork(net)


def test_wrap_codes_equal_jax():
    assert (WRAP_REPEAT, WRAP_MIRROR, WRAP_CLAMP) == (J_REPEAT, J_MIRROR,
                                                      J_CLAMP)
    assert tmn._WRAP_TOKENS == jmn._WRAP_TOKENS
    assert tmn._SLOT_OF_INPUT == jmn._SLOT_OF_INPUT
    assert tmn._DEFAULT_SWIZZLE == jmn._DEFAULT_SWIZZLE


def test_graph_parse_texture_descriptor():
    t, j = both(graph_net(rotation=30.0))
    assert_same_network(t, j)
    desc = t.texture_for_slot(0)
    assert desc.wrap_u == WRAP_REPEAT and desc.wrap_v == WRAP_CLAMP
    th = math.radians(30.0)
    assert desc.uv_transform[0] == pytest.approx(2.0 * math.cos(th))
    assert desc.uv_transform[4] == pytest.approx(0.1)
    assert any(p.name == "diffuseColor" and p.type == tmn.ParamType.TEXTURE
               for p in t.parameters)


def test_graph_surface_values_and_fallbacks():
    t, j = both(graph_net(surf_params={"roughness": 0.25, "metallic": 0.75,
                                       "opacityThreshold": 0.5}))
    assert_same_network(t, j)
    assert (t.roughness, t.metallic, t.tag) == (0.25, 0.75, "masked")


def test_opacity_texture_makes_translucent():
    t, j = both(graph_net(extra_conn=[("/m/surf", "opacity", "/m/tex",
                                       "a")]))
    assert_same_network(t, j)
    assert t.tag == "translucent"


@pytest.mark.parametrize("wraps", [("mirror", "black"), ("clamp", "repeat"),
                                   ("useMetadata", "bogus")])
def test_wrap_tokens(wraps):
    t, j = both(graph_net(wrapS=wraps[0], wrapT=wraps[1]))
    assert_same_network(t, j)


def test_transform2d_compose_matches_jax_and_sequential():
    pairs = [((2.0, 0.5), 30.0, (0.1, -0.2)), ((1.5, 1.0), -45.0, (0.3, 0.4))]
    ta, tb = (tmn.Transform2d(*p) for p in pairs)
    ja, jb = (jmn.Transform2d(*p) for p in pairs)
    m = tmn._compose(ta, tb).as_scale_rot_bias()
    assert m == jmn._compose(ja, jb).as_scale_rot_bias()

    def apply(t, uv):
        th = math.radians(t.rotation)
        su, sv = t.scale
        x, y = uv[0] * su, uv[1] * sv
        return (x * math.cos(th) - y * math.sin(th) + t.translation[0],
                x * math.sin(th) + y * math.cos(th) + t.translation[1])
    for uv in [(0.0, 0.0), (1.0, 0.0), (0.3, 0.7)]:
        want = apply(ta, apply(tb, uv))
        got = (uv[0] * m[0] + uv[1] * m[2] + m[4],
               uv[0] * m[1] + uv[1] * m[3] + m[5])
        assert got == pytest.approx(want, abs=1e-5)


def test_chained_transform2d_nodes_compose_like_jax():
    net = graph_net(scale=(2.0, 0.5), rotation=20.0)
    net["nodes"]["/m/xf2"] = {"type": "UsdTransform2d",
                              "params": {"scale": (1.5, 1.0),
                                         "rotation": -45.0,
                                         "translation": (0.3, 0.4)}}
    net["connections"] = [c for c in net["connections"]
                          if c[:2] != ("/m/xf", "in")]
    net["connections"] += [("/m/xf", "in", "/m/xf2", "result"),
                           ("/m/xf2", "in", "/m/st", "result")]
    assert_same_network(*both(net))


def test_transform2d_matrix_matches_apply_uv_transform():
    """The 6-float form the port's ops/texture.apply_uv_transform takes
    equals the reference's rotate(scale * uv) + t."""
    from diligentfx_tpu_torch.ops.texture import apply_uv_transform
    t = tmn.Transform2d((2.0, 0.5), 37.0, (0.15, -0.25))
    m = torch.tensor(t.as_scale_rot_bias(), dtype=torch.float32)
    uv = torch.tensor([[0.3, 0.7], [1.0, 0.0], [0.0, 1.0]])
    got = apply_uv_transform(uv, m[:4], m[4:]).numpy()
    th = math.radians(37.0)
    for i, (u, v) in enumerate(uv.tolist()):
        x, y = u * 2.0, v * 0.5
        assert got[i] == pytest.approx(
            (x * math.cos(th) - y * math.sin(th) + 0.15,
             x * math.sin(th) + y * math.cos(th) - 0.25), abs=1e-5)


def _single_channel_net(inp, channel, img):
    return {"nodes": {"/m/surf": {"type": "UsdPreviewSurface", "params": {}},
                      "/m/tex": {"type": "UsdUVTexture",
                                 "params": {"file": img}}},
            "connections": [("/m/surf", inp, "/m/tex", channel)],
            "terminal": "/m/surf"}


@pytest.mark.parametrize("inp,channel", [
    ("roughness", "r"), ("metallic", "b"), ("roughness", "a"),
    ("occlusion", "g"), ("occlusion", "a"), ("metallicRoughness", "gb")])
def test_normalized_payload_swizzles(inp, channel):
    img = np.random.default_rng(2).random((4, 4, 4)).astype(np.float32)
    t, j = both(_single_channel_net(inp, channel, img))
    assert_same_network(t, j)
    if (inp, channel) == ("roughness", "r"):
        out = tmn.normalized_payload(t.texture_for_slot(2), 2)
        np.testing.assert_array_equal(out[..., 1], img[..., 0])


def test_normalized_payload_loader_and_2d_image():
    img = np.random.default_rng(4).random((6, 5)).astype(np.float32)
    for payload in (img, lambda: img):
        t, j = both(_single_channel_net("roughness", "r", payload))
        assert_same_network(t, j)


def test_primvar_redirect_param():
    net = {"nodes": {"/m/surf": {"type": "UsdPreviewSurface", "params": {}},
                     "/m/pv": {"type": "UsdPrimvarReader_float3",
                               "params": {"varname": "displayColor",
                                          "fallback": (1, 0, 0)}}},
           "connections": [("/m/surf", "diffuseColor", "/m/pv", "result")],
           "terminal": "/m/surf"}
    t, j = both(net)
    assert_same_network(t, j)
    p = [q for q in t.parameters if q.type == tmn.ParamType.PRIMVAR_REDIRECT]
    assert p and p[0].sampler_coords == ("displayColor",)


def test_legacy_flat_form_still_parses():
    t, j = both({"surface": {"diffuseColor": (1, 0, 0), "opacity": 0.5},
                 "textures": {"diffuseColor": _checker(),
                              "emissiveColor": None}})
    assert_same_network(t, j)
    assert t.tag == "translucent" and t.diffuse_color == (1, 0, 0)


def test_no_terminal_and_empty_network():
    assert_same_network(*both({"nodes": {"/x": {"type": "Other"}}}))
    assert_same_network(*both(None))


# ---------------------------------------------------------------------------
# End to end on the port: UV transform + wraps reach the sampled pixels
# ---------------------------------------------------------------------------


def _render_basecolor(network):
    from diligentfx_tpu_torch.hydrogent.render_delegate import \
        HnRenderDelegate
    from diligentfx_tpu_torch.hydrogent.task_manager import \
        TaskManagerCreateInfo
    renderer = small_port_renderer()
    d = HnRenderDelegate(renderer=renderer, device="cpu",
                         task_manager_ci=TaskManagerCreateInfo(
                             enable_ssao=False, enable_ssr=False,
                             enable_taa=False, enable_bloom=False))
    d.create_sprim("material", "/m").set_network(network)
    mesh = d.create_rprim("mesh", "/quad")
    mesh.set_points([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]])
    mesh.set_primvar("st", [[0, 0], [1, 0], [1, 1], [0, 1]])
    mesh.set_topology([4], [0, 1, 2, 3])
    mesh.set_material("/m")
    d.create_sprim("camera", "/cam").set_params(eye=(0, 0, 3.2),
                                                target=(0, 0, 0))
    d.create_sprim("light", "/sun").set_params(
        type="distant", direction=(0, 0, -1), intensity=3.0)
    return d.execute(128, 128).gbuffer.base_color.numpy()


def test_uv_transform_tiles_texture():
    """scale(2, 2) repeat: twice the checker frequency of the identity."""
    tex = _checker(32, 2)

    def freq(img):
        row = img[64, :, 0]
        return int(np.sum(np.abs(np.diff((row > row.mean()).astype(int)))))
    ident = _render_basecolor(graph_net(scale=(1, 1), translation=(0, 0),
                                        wrapT="repeat", tex=tex))
    tiled = _render_basecolor(graph_net(scale=(2, 2), translation=(0, 0),
                                        wrapT="repeat", tex=tex))
    assert freq(tiled) >= 2 * freq(ident) - 2
    assert freq(tiled) > freq(ident)


def test_wrap_clamp_vs_repeat_outside_unit():
    """uv shifted outside [0, 1]: repeat re-tiles (varying), clamp
    saturates to the edge texel (constant along u)."""
    tex = _checker(32, 4)
    rep = _render_basecolor(graph_net(scale=(1, 1), translation=(1.25, 0),
                                      wrapS="repeat", wrapT="repeat",
                                      tex=tex))
    clp = _render_basecolor(graph_net(scale=(1, 1), translation=(1.25, 0),
                                      wrapS="clamp", wrapT="repeat",
                                      tex=tex))
    assert rep[40:88, 40:88, 0].std(axis=1).mean() > 0.05
    assert clp[40:88, 40:88, 0].std(axis=1).mean() < 0.02
