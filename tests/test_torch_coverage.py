"""Module parity of the port: every top-level name of every module of the
JAX package (and every member of a class that both packages define) has a
counterpart of the same name in the port module at the same relative path,
or an entry in the tables below with the port's counterpart and the reason
it differs. Both packages are read with `ast`; neither is imported.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "splatter_a_video_tpu"
PORT_PKG = ROOT / "splatter_a_video_tpu_torch"

# JAX module -> port module, where the paths differ
RENAMED = {"ops/rasterize_tpu.py": "ops/rasterize_gpu.py"}

# JAX modules with no port module: module -> (port counterpart, reason)
NOT_PORTED_MODULES = {
    "utils/runtime.py": ("none; the CLIs take --device",
                         "enables JAX's persistent compilation cache and forces JAX onto the CPU"),
}

TPU_CHOICE = "a TPU implementation choice of one result; the port computes that result one way"
JIT_MODEL = "a frozen parameter dataclass that jit hashes; the port holds the weights in an nn.Module"

# (JAX module, name or Class.member) -> (port counterpart, reason)
COUNTERPARTS = {
    ("__init__.py", "__version__"): ("none", "the JAX package's version string; the port has none of its own"),
    ("ops/__init__.py", "__all__"): ("none", "lists the submodules the JAX ops package imports eagerly; the port's "
                                             "imports none, so CUDA code loads only when used"),
    ("data/native_loader.py", "_lib_path"): ("native_loader.library_path",
                                             "the JAX loader uses the tracked native/libsav_loader.so; the port "
                                             "builds its own copy under _build/"),
    ("data/native_loader.py", "_src_path"): ("native_loader.SOURCE", "the path of native/sav_loader.cpp"),
    ("eval/lpips.py", "LpipsModel"): ("eval/lpips.Lpips", JIT_MODEL),
    ("eval/lpips.py", "_MODEL"): ("eval/lpips._MODELS", "the cached model; the port caches one per device"),
    ("eval/lpips.py", "_conv_names"): ("eval/lpips._vgg_forward", "names of VGG16's convolutions in the parameter "
                                                                  "dict; the port walks the same config"),
    ("eval/lpips.py", "_vgg_taps"): ("eval/lpips._vgg_forward(normalize=True)", "a jit entry point"),
    ("eval/lpips.py", "_lpips_pair"): ("eval/lpips.Lpips.forward", "a jit entry point"),
    ("nets/depth_anything.py", "DepthAnythingModel"): ("nets/depth_anything.DepthAnything", JIT_MODEL),
    ("nets/depth_anything.py", "_infer"): ("nets/depth_anything.DepthAnything.forward", "a jit entry point"),
    ("nets/tapir.py", "TapirModel"): ("nets/tapir.Tapir", JIT_MODEL),
    ("nets/tapir.py", "_infer"): ("nets/tapir.Tapir.forward", "a jit entry point"),
    ("ops/binning.py", "bin_sort_pack"): ("ops/binning.bin_intersections",
                                          "binning with the packed TPU layout; the port bins without packing"),
    ("ops/binning.py", "_bin_sort_pack_presorted"): ("ops/binning.bin_intersections",
                                                     "the presorted path equals sort_mode 'exact', the port's only "
                                                     "order"),
    ("ops/binning.py", "_monotone_expand_pallas"): ("ops/rasterize_gpu.expand_intersections",
                                                    "the Pallas tile expansion; the port's is CUDA kernel K2"),
    ("ops/binning.py", "_fill_forward"): ("ops/rasterize_gpu.expand_intersections", TPU_CHOICE),
    ("ops/binning.py", "_local_cummax"): ("ops/rasterize_gpu.expand_intersections", TPU_CHOICE),
    ("ops/binning.py", "_edges_matmul"): ("torch.searchsorted in ops/binning.bin_intersections", TPU_CHOICE),
    ("ops/binning.py", "_searchsorted_left"): ("torch.searchsorted in ops/binning.bin_intersections", TPU_CHOICE),
    ("ops/binning.py", "_pack_and_edges"): ("ops/rasterize_gpu.pack_records",
                                            "packs lane-aligned chunks for the Pallas kernels; K1 and K3 read "
                                            "32-byte records"),
    ("ops/binning.py", "_round_up_int"): ("none", "pads to the TPU chunk; the port pads nothing"),
    ("ops/binning.py", "grad_buffer_size"): ("none", "sizes the TPU backward's chunk-slot buffer; K3 writes one row "
                                                     "per slot of the budget"),
    ("ops/binning.py", "Binning.packed"): ("ops/rasterize_gpu.pack_records", "the packed TPU layout"),
    ("ops/binning.py", "Binning.chunk"): ("none", "the packed TPU layout's chunk"),
    ("ops/binning.py", "Binning.chunk_base"): ("none", "the packed TPU layout's chunk offsets"),
    ("ops/binning.py", "Binning.num_tiles"): ("Binning.num_tiles_x * num_tiles_y", "a convenience property"),
    ("ops/binning.py", "Binning.perm"): ("Binning.order", "the sort permutation; the port always keeps it"),
    ("ops/binning.py", "Binning.prepos"): ("Binning.order", "the pre-sort positions of the carry_prepos option"),
    ("ops/projection.py", "Projection"): ("ops/rasterize.Projected", "the projected Gaussians' fields"),
    ("ops/rasterize.py", "RasterizeConfig.chunk"): ("none", TPU_CHOICE),
    ("ops/rasterize.py", "RasterizeConfig.edges_mode"): ("none", TPU_CHOICE),
    ("ops/rasterize.py", "RasterizeConfig.expand_mode"): ("none", TPU_CHOICE),
    ("ops/rasterize.py", "RasterizeConfig.interpret"): ("none", "runs Pallas in interpret mode off the TPU; on a "
                                                                "CPU tensor the port runs each kernel's plain version"),
    ("ops/rasterize.py", "RasterizeConfig.scan_impl"): ("none", TPU_CHOICE),
    ("ops/rasterize.py", "RasterizeConfig.sort_mode"): ("none", "the port always sorts by the full f32 depth, JAX's "
                                                                "sort_mode 'exact'"),
    ("ops/rasterize_tpu.py", "_fwd_kernel"): ("csrc/blend_forward.cu (K1), ops/rasterize_gpu.blend_forward",
                                              "the Pallas forward blend"),
    ("ops/rasterize_tpu.py", "_fwd_kernel_entry"): ("ops/rasterize_gpu.blend_forward", "the Pallas kernel's entry"),
    ("ops/rasterize_tpu.py", "_bwd_kernel"): ("csrc/blend_backward.cu (K3), ops/rasterize_gpu.blend_backward",
                                              "the Pallas backward blend"),
    ("ops/rasterize_tpu.py", "_build_splat"): ("ops/rasterize_gpu._Splat and reduce_gaussians (K4)",
                                               "builds the custom-VJP splat for one static configuration"),
    ("ops/rasterize_tpu.py", "_chunk_alpha"): ("csrc/blend_batch.cuh", "the per-chunk alpha of the TPU kernels"),
    ("ops/rasterize_tpu.py", "_pixel_coords"): ("csrc/blend_forward.cu", "pixel coordinates of a TPU tile"),
    ("ops/rasterize_tpu.py", "_cumsum_lanes"): ("none", "the transmittance scan across TPU lanes; the CUDA kernels "
                                                        "blend each pixel in order"),
    ("ops/rasterize_tpu.py", "_cumsum_lanes_roll"): ("none", TPU_CHOICE),
    ("ops/rasterize_tpu.py", "_cumsum_lanes_split"): ("none", TPU_CHOICE),
    ("ops/rasterize_tpu.py", "_scan_lanes"): ("none", TPU_CHOICE),
    ("ops/rasterize_tpu.py", "_tri_incl"): ("none", "a triangular matrix of the lane scan"),
    ("ops/rasterize_tpu.py", "_tri_excl"): ("none", "a triangular matrix of the lane scan"),
    ("ops/rasterize_tpu.py", "_LOG2E"): ("none", "the TPU exponentiates in base 2; the CUDA kernels call expf"),
    ("ops/rasterize_tpu.py", "_LN2"): ("none", "the TPU exponentiates in base 2; the CUDA kernels call expf"),
    ("ops/rasterize_tpu.py", "_PLANAR_RENDER"): ("none", "an environment switch of the TPU kernel's layout"),
    ("ops/rasterize_tpu.py", "_round_up"): ("none", "pads to the TPU chunk; the port pads nothing"),
    ("ops/rasterize_tpu.py", "DEFAULT_TILE"): ("ops/rasterize.RasterizeConfig.block_x / block_y",
                                               "the default 16x16 tile"),
    ("ops/rasterize_tpu.py", "packed_rows"): ("ops/rasterize_gpu.pack_records", "rows of the packed TPU layout"),
    ("ops/rasterize_tpu.py", "grad_rows"): ("ops/rasterize_gpu.blend_backward", "rows of a slot's gradient; the "
                                                                               "port derives them from C"),
    ("ops/ssim.py", "_gaussian_window"): ("ops/ssim._band_matrix", "the 2-D window; the port blurs separably"),
    ("ops/ssim.py", "_depthwise_conv"): ("none", "a cross-check for non-separable windows, off the JAX hot path"),
    ("parallel/dp.py", "_partial_shmap"): ("none", "shard_map over a mesh; each torch.distributed rank runs the "
                                                   "step"),
    ("parallel/mesh.py", "replicated"): ("none", "a JAX sharding spec; each rank holds its own tensors"),
    ("parallel/mesh.py", "batch_sharded"): ("parallel/dp.local_batch", "a JAX sharding spec; each rank takes its "
                                                                        "slot of the stacked batch"),
    ("parallel/mesh.py", "shard_map_nocheck"): ("none", "a JAX version shim for shard_map"),
    ("parallel/render_shard.py", "_composite_fold"): ("parallel/render_shard.fold_partials",
                                                      "the fold inside shard_map"),
    ("train/engine.py", "_replace_dataclass"): ("dataclasses.replace", "a one-line wrapper"),
    ("train/optim.py", "make_optimizer"): ("train/optim.adam_init / adam_update",
                                           "an optax transform; the port's Adam is hand-written with optax's "
                                           "semantics"),
    ("models/gaussians.py", "GaussianScene.replace"): ("dataclasses.replace", "a one-line wrapper"),
    ("models/gaussians.py", "GaussianScene.tree_flatten"): ("none", "JAX pytree registration"),
    ("models/gaussians.py", "GaussianScene.tree_unflatten"): ("none", "JAX pytree registration"),
    ("models/atlas.py", "AtlasModel.tree_flatten"): ("none", "JAX pytree registration"),
    ("models/atlas.py", "AtlasModel.tree_unflatten"): ("none", "JAX pytree registration"),
}


def _body_names(body):
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def module_names(path: pathlib.Path):
    """Top-level names of a module, and `Class.member` for each member of
    each top-level class."""
    tree = ast.parse(path.read_text())
    names = _body_names(tree.body)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{m}" for m in _body_names(node.body))
    return names


def port_path(rel: str) -> pathlib.Path:
    return PORT_PKG / RENAMED.get(rel, rel)


def missing_names(rel: str):
    """Names of the JAX module `rel` that its port module lacks; a member
    counts only when the port defines its class."""
    jax_names = module_names(JAX_PKG / rel)
    port_names = module_names(port_path(rel))
    return sorted(n for n in jax_names - port_names
                  if "." not in n or n.split(".")[0] in port_names)


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_has_port_counterpart(rel):
    if rel in NOT_PORTED_MODULES:
        assert not port_path(rel).exists(), f"{rel} is ported now: remove it from NOT_PORTED_MODULES"
        return
    assert port_path(rel).exists(), f"no port module for {rel}"
    unexplained = [n for n in missing_names(rel) if (rel, n) not in COUNTERPARTS]
    assert not unexplained, f"{rel}: names with no port counterpart and no table entry: {unexplained}"


def test_table_entries_are_needed():
    """Every table entry names a JAX name that the port really lacks, with
    a counterpart and a reason."""
    stale = [(rel, n) for rel, n in COUNTERPARTS if n not in missing_names(rel)]
    assert not stale, f"entries for names the port has, or the JAX package lacks: {stale}"
    assert all(c and r for c, r in COUNTERPARTS.values())
    assert all((JAX_PKG / rel).exists() for rel in NOT_PORTED_MODULES)


@pytest.mark.parametrize("flag", ["--refine_camera", "--distributed"])
def test_cli_help_states_ported_features(flag):
    """The training CLI's help describes what the port does for options
    that earlier slices ported: no option is "not ported", and neither of
    these says it raises."""
    from splatter_a_video_tpu_torch.utils import config

    parser = config.make_arg_parser()
    helps = {a.option_strings[0]: a.help or "" for a in parser._actions if a.option_strings}
    assert not any("not ported" in h for h in helps.values())
    assert helps[flag] and "raise" not in helps[flag]
