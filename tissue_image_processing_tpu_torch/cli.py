"""Main pipeline CLI of the PyTorch/CUDA port: the batch replacement for the
reference's PyQt GUI. Every worker-thread action of the GUI (segment / U-Net
segment / cell types / track / find events / save / export) is a subcommand
operating on a movie and a ``.seg`` session, with frames processed on the
card in batches.

Port of ``tissue_image_processing_tpu/cli.py``: the same ten subcommands,
flags, defaults and printed lines. ``main(argv, device=None)`` runs on the
CUDA card and raises before it touches a file when there is none;
``main(argv, device="cpu")`` runs the plain PyTorch route.

Usage examples:
  python -m tissue_image_processing_tpu_torch.cli segment movie.tif --session out.seg
  python -m tissue_image_processing_tpu_torch.cli pipeline movie.npy --session out.seg
  python -m tissue_image_processing_tpu_torch.cli unet movie.tif --weights w.h5 --session out.seg
  python -m tissue_image_processing_tpu_torch.cli types --session out.seg movie.tif --channel 1 --name HC
  python -m tissue_image_processing_tpu_torch.cli track --session out.seg movie.tif
  python -m tissue_image_processing_tpu_torch.cli events --session out.seg
  python -m tissue_image_processing_tpu_torch.cli export --session out.seg --format matlab out/
  python -m tissue_image_processing_tpu_torch.cli analyze --session out.seg --feature area
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.core.pipeline import (
    _upload, movie_pipeline, movie_pipeline_chunked)


def _load_movie(path):
    from tissue_image_processing_tpu_torch.io.movie import MovieStore
    return MovieStore.open(path)


def _open_session(args, n_frames):
    from tissue_image_processing_tpu_torch.core.tissue import Tissue

    tissue = Tissue(n_frames, args.movie if hasattr(args, "movie") else "session",
                    channel_names=getattr(args, "channels", None) or [],
                    capacity=args.capacity, device=args.device)
    if args.session and os.path.isfile(args.session):
        for _ in tissue.load(args.session):
            pass
    return tissue


def _save_session(tissue, args):
    if args.session:
        for _ in tissue.save(args.session):
            pass
        print(f"saved session -> {args.session}")


def cmd_segment(args):
    """Watershed each frame of ``--channel`` on the device, in the labels'
    x-major space (the frame transposed), and tabulate it."""
    from tissue_image_processing_tpu_torch.ops.watershed import (
        watershed_segmentation)

    store = _load_movie(args.movie)
    tissue = _open_session(args, store.num_frames)
    frames = range(args.initial, (args.final or store.num_frames) + 1)
    for f in frames:
        img = _upload(store.frame(f - 1)[args.channel, 0].T.astype(np.float32),
                      args.device)
        labels = watershed_segmentation(img, args.threshold, args.std,
                                        args.block_size).cpu().numpy()
        tissue.set_labels(f, labels, reset_data=True)
        tissue.calculate_frame_cellinfo(f)
        print(f"segmented frame {f}: {labels.max()} cells", flush=True)
    _save_session(tissue, args)


def _auto_chunk_frames(store, budget_bytes=2 << 30, multiple=1):
    """Frames per chunk so one staged chunk stays under ~2 GiB of device
    memory (the float32 intermediates of a chunk peak at a few times that;
    the H100's 80 GB has room). Chunks are read in the store's NATIVE dtype
    (uint16 for microscope data; float32 stores are twice that). 0 = the
    whole movie fits. The budget and rounding are the JAX CLI's, so both
    packages chunk a movie alike.

    ``multiple``: round the chunk down to a multiple of the per-launch
    batch: a prime chunk length (e.g. 17) would force the stacked flood down
    to one frame a launch, and the U-Net forward below its batch."""
    itemsize = np.dtype(getattr(store.data, "dtype", np.uint16)).itemsize
    per_frame = int(np.prod(store.shape[1:])) * itemsize
    total = per_frame * store.num_frames
    if total <= budget_bytes:
        return 0
    chunk = max(1, budget_bytes // max(per_frame, 1))
    if multiple > 1 and chunk >= multiple:
        chunk -= chunk % multiple
    return chunk


def _build_unet_config(args, store, channels, reference_channel):
    """Predictor for ``pipeline --unet``: load and fold the weights, with
    ``--quantize`` calibrate the int8 scales on the movie's projected first
    frame, and package it for the pipeline
    (``SegmentationPredictor.pipeline_config``). ``reference_channel``
    indexes within the selected (atoh, zo) pair."""
    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor)

    shape = tuple(store.shape[-2:])  # (Y, X) without decoding a frame
    pred = SegmentationPredictor(args.weights, (2,) + shape,
                                 depth=args.unet_depth,
                                 base_filters=args.unet_filters,
                                 quantize=args.quantize, device=args.device)
    if pred.quantize:
        from tissue_image_processing_tpu_torch.projection.surface import (
            project_timepoint_auto)

        # the ONE frame decode of startup (lazy / zstd stores decode per touch)
        stack0 = _upload(store.frame(0)[list(channels)].astype(np.float32),
                         args.device)
        if stack0.shape[1] > 1:
            prj0 = project_timepoint_auto(
                stack0, reference_channel=reference_channel)[0]
        else:
            prj0 = stack0[:, 0]
        pred.calibrate(prj0)
    return pred.pipeline_config(batch=args.unet_batch)


def cmd_pipeline(args):
    """Whole-movie run: projection -> segmentation -> tables -> drift ->
    tracking on the device (``core/pipeline.py``), then populate the
    session: the reference's segment-all + track workflow without its
    per-frame host round trips. Movies larger than the budget of
    :func:`_auto_chunk_frames` stream in T-chunks with the tracking state
    carried across (``movie_pipeline_chunked``; ``--chunk`` forces a chunk
    size), so a movie of any length runs."""
    from tissue_image_processing_tpu_torch.core.cell_table import frame_cellinfo

    store = _load_movie(args.movie)
    tissue = _open_session(args, store.num_frames)
    kw = dict(reference_channel=args.channel, threshold=args.threshold,
              std=args.std, block_size=args.block_size, capacity=args.capacity,
              batch=args.batch, search_range=args.search_range,
              memory=args.memory, device=args.device)
    channels = None
    if getattr(args, "unet", False):
        # U-Net segmentation: the model consumes the (atoh, zo) channel pair
        # of the projected frame; projection still uses --channel as the
        # reference within that pair
        channels = (args.atoh_channel, args.zo_channel)
        # --channel names a STORE channel; inside the selected (atoh, zo)
        # pair it sits at its pair index
        ref_in_pair = (channels.index(args.channel)
                       if args.channel in channels else 0)
        kw["reference_channel"] = ref_in_pair
        kw["unet"] = _build_unet_config(args, store, channels, ref_in_pair)
    elif getattr(args, "cellpose", None):
        # Cellpose segmentation: a user's v2 cyto* state_dict, loaded
        # strictly; the network takes the (zo, atoh) pair as its
        # (cytoplasm, nucleus) channels
        from tissue_image_processing_tpu_torch.models.cellpose import (
            CellposePredictor)

        channels = (args.zo_channel, args.atoh_channel)
        kw["reference_channel"] = (channels.index(args.channel)
                                   if args.channel in channels else 0)
        kw["cellpose"] = CellposePredictor(
            args.cellpose, diameter=args.cp_diameter, channels=(0, 1),
            device=args.device).pipeline_config()
    per_launch = (args.unet_batch if getattr(args, "unet", False)
                  else kw["cellpose"]["batch"] if "cellpose" in kw
                  else args.batch)
    chunk = (args.chunk if args.chunk is not None
             else _auto_chunk_frames(store, multiple=per_launch))
    overflow_frames = []

    def apply_frames(t0, labels, tabs, ids_c, masks, overflow):
        """``tabs``: the chunk's stacked host tables, sliced per frame."""
        for i in range(labels.shape[0]):
            f = t0 + i + 1
            tissue.set_labels(f, labels[i], reset_data=True)
            t = tabs.map(lambda x: x[i].clone())
            if overflow[i]:
                # this frame's compacted adjacency dropped pairs; recompute
                # it with the exact neighbour scatter
                t = frame_cellinfo(_upload(labels[i], args.device),
                                   capacity=args.capacity).map(
                                       lambda x: x.cpu())
                overflow_frames.append(f)
            tissue.apply_track_ids(f, t, ids_c[i], masks[i])

    if chunk and chunk < store.num_frames:
        print(f"streaming {store.num_frames} frames in chunks of {chunk}",
              flush=True)
        ids_all = []

        def sink(t0, c):
            tabs = c["tables"]
            apply_frames(t0, c["labels"], tabs, c["ids"],
                         tabs.valid_mask().numpy(), c["neighbor_overflow"])
            tissue.drifts[t0:t0 + c["ids"].shape[0]] = c["drifts"]
            ids_all.append(c["ids"])
            print(f"  frames {t0 + 1}-{t0 + c['ids'].shape[0]} done",
                  flush=True)

        movie_pipeline_chunked(store, chunk_frames=chunk, on_chunk=sink,
                               keep_labels=False, channels=channels, **kw)
        ids = np.concatenate(ids_all, axis=0)
    else:
        data = store.data
        if channels is not None:
            data = np.asarray(data)[:, list(channels)]
        out = movie_pipeline(data, **kw)
        labels = out["labels"].cpu().numpy()
        ids = out["ids"]
        # ONE stacked device -> host copy of each table field for all frames,
        # not a read per frame
        tabs = out["tables"].map(lambda t: t.cpu())
        apply_frames(0, labels, tabs, ids, tabs.valid_mask().numpy(),
                     out["neighbor_overflow"])
        tissue.drifts[:store.num_frames] = out["drifts"]
    n_tracked = int((ids > 0).any(0).sum())
    print(f"pipeline: {store.num_frames} frames, "
          f"{int((ids[0] > 0).sum())} cells in frame 1, "
          f"{n_tracked} tracks", flush=True)
    if overflow_frames:
        print("adjacency overflow: frames "
              f"{', '.join(map(str, overflow_frames))} recomputed with the "
              "exact neighbor scatter", flush=True)
    if args.events:
        for _ in tissue.find_events_iterator(1, store.num_frames):
            pass
        print(f"events: {len(tissue.events)} found", flush=True)
    _save_session(tissue, args)


def cmd_unet(args):
    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor)

    store = _load_movie(args.movie)
    tissue = _open_session(args, store.num_frames)
    shape = store.frame(0)[0, 0].shape
    pred = SegmentationPredictor(args.weights, (2,) + shape,
                                 quantize=args.quantize, device=args.device)
    frames = list(range(args.initial, (args.final or store.num_frames) + 1))
    # frames go through the U-Net in batches of 8 (the batch the pipeline's
    # forward and its stacked post-process flood use)
    for g in range(0, len(frames), 8):
        group = frames[g:g + 8]
        imgs = np.stack([store.frame(f - 1)[[args.atoh_channel,
                                             args.zo_channel], 0]
                         for f in group]).astype(np.float32)
        labels_b, _ = pred.predict_batch(_upload(imgs, args.device))
        labels_b = labels_b.cpu().numpy()
        for f, labels in zip(group, labels_b):
            tissue.set_labels(f, labels, reset_data=True)
            tissue.calculate_frame_cellinfo(f)
            print(f"unet-segmented frame {f}: {int(labels.max())} cells",
                  flush=True)
    _save_session(tissue, args)


def cmd_types(args):
    store = _load_movie(args.movie)
    tissue = _open_session(args, store.num_frames)
    for f in range(1, store.num_frames + 1):
        if tissue.get_labels(f) is None:
            continue
        marker = store.frame(f - 1)[args.channel, 0].T.astype(np.float32)
        tissue.calc_cell_types(marker, f, args.name, threshold=args.threshold,
                               percentage_above_threshold=args.percentage)
        print(f"typed frame {f}", flush=True)
    _save_session(tissue, args)


def cmd_track(args):
    store = _load_movie(args.movie) if args.movie else None
    n = store.num_frames if store else args.frames
    tissue = _open_session(args, n)
    images = None
    if store is not None and args.use_images:
        images = store.data[:, args.channel, 0].transpose(0, 2, 1)
    tissue.track_cells(images=images, search_range=args.search_range,
                       memory=args.memory)
    if args.fix_types:
        tissue.fix_cell_types_after_tracking()
    print(f"tracked {n} frames; {tissue.get_cells_number()} tracks")
    _save_session(tissue, args)


def cmd_events(args):
    tissue = _open_session(args, args.frames)
    tissue.find_events(differentiation_type_name=args.type_name)
    ev = tissue.get_events()
    print(ev.groupby("type").size().to_string() if len(ev) else "no events found")
    _save_session(tissue, args)


def cmd_export(args):
    from tissue_image_processing_tpu_torch.core import export as X

    tissue = _open_session(args, args.frames)
    os.makedirs(args.outdir, exist_ok=True)
    name = args.name or "export"
    if args.format == "matlab":
        X.export_segmentation_to_matlab(tissue, args.outdir, name)
    elif args.format == "tiff":
        X.export_segmentation_to_tiff(tissue, args.outdir, name)
    elif args.format == "tiff+types":
        X.export_segmentation_and_cell_types_to_tiff(tissue, args.outdir, name)
    elif args.format == "npy":
        X.export_segmentation_to_npy(tissue, args.outdir, name)
    elif args.format == "events":
        X.write_table(tissue.get_events(), os.path.join(args.outdir, name + ".csv"))
    print(f"exported -> {args.outdir}")


def cmd_analyze(args):
    import pandas as pd

    from tissue_image_processing_tpu_torch.core.export import write_table
    from tissue_image_processing_tpu_torch.core.frame_data import get_frame_data

    tissue = _open_session(args, args.frames)
    rows = []
    for f in range(1, args.frames + 1):
        if tissue.get_cells_info(f) is None:
            continue
        mask = tissue.get_valid_non_edge_mask(f)
        data, msg = get_frame_data(tissue, f, args.feature, mask)
        if data is None:
            print(f"frame {f}: {msg}")
            continue
        arr = np.atleast_1d(np.asarray(data, float))
        rows.append({"frame": f, "mean": arr.mean(), "std": arr.std(),
                     "n": arr.size})
    df = pd.DataFrame(rows)
    print(df.to_string(index=False))
    if args.out:
        write_table(df, args.out)
    if getattr(args, "interactive", False):
        _embed_console({"tissue": tissue, "df": df, "args": args})


def _kernel_libraries(args):
    """The ``csrc`` libraries that ``cli pipeline`` launches kernels from
    with these flags: the watershed set (the blur and the floods, and the
    fused projection for a stack it accepts), the adaptive radii's sweep,
    the tracker's auction, ``cc_scan`` on the U-Net path and ``conv_s8`` on
    its int8 form. Maps each library name to its loader's ctypes
    signatures."""
    from tissue_image_processing_tpu_torch.core import tracking
    from tissue_image_processing_tpu_torch.ops import (blur_cuda,
                                                       conv_s8_cuda,
                                                       flood_cuda)
    from tissue_image_processing_tpu_torch.projection import fused

    libs = {"blur3d": blur_cuda._SIGNATURES, "flood": flood_cuda._SIGNATURES,
            "radii": tracking._RADII_SIGNATURES,
            "auction": tracking._AUCTION_SIGNATURES}
    C = 2 if getattr(args, "unet", False) else args.channels_n
    if args.zdepth > 1 and fused.fused_projection_supported(
            (C, args.zdepth, args.size, args.size)):
        libs["projection"] = fused._SIGNATURES
    if getattr(args, "unet", False):
        libs["cc_scan"] = flood_cuda._SCAN_SIGNATURES
        if args.quantize:
            libs["conv_s8"] = conv_s8_cuda._SIGNATURES
    return libs


def cmd_warmup(args):
    """Pay a pipeline run's one-off start-up costs ahead of it. The port
    compiles no device program ahead of time; what lasts across processes
    is the ``nvcc`` build of the kernel libraries that ``cli pipeline``
    launches with these flags, kept by source hash in the build cache
    (``utils/runtime.py:enable_compilation_cache``). So ``warmup`` builds
    and loads those libraries and, with ``--unet``, builds the predictor at
    ``--unet-depth`` / ``--unet-filters`` (calibrating it on a dummy frame
    with ``--quantize``), printing the seconds of each. It does not run the
    path on a dummy movie: nothing such a run warms (allocator pools, cuDNN
    plans) outlives the process. On the CPU there is no kernel to build."""
    from tissue_image_processing_tpu_torch import _device

    T, C, Z, H, W = args.frames, args.channels_n, args.zdepth, args.size, args.size
    if args.device.type == "cuda":
        libs = _kernel_libraries(args)
        t0 = time.time()
        _device.build_kernels(libs)
        for name, signatures in libs.items():
            _device.load_library(name, signatures)
        print(f"kernel libraries [{', '.join(libs)}] ({T}x{C}x{Z}x{H}x{W}): "
              f"built in {time.time() - t0:.1f}s", flush=True)
    else:
        print(f"kernel libraries: none on {args.device.type} (the plain "
              "PyTorch route has no kernel to build)", flush=True)
    if getattr(args, "unet", False):
        from tissue_image_processing_tpu_torch.models.predictor import (
            SegmentationPredictor)

        t0 = time.time()
        pred = SegmentationPredictor(None, (2, H, W), depth=args.unet_depth,
                                     base_filters=args.unet_filters,
                                     quantize=args.quantize, device=args.device)
        if pred.quantize:
            pred.calibrate(np.zeros((2, 64, 64), np.float32) + 1.0)
        cfg = pred.pipeline_config(batch=args.unet_batch)
        print(f"unet predictor (2x{H}x{W}, depth {cfg['depth']}, "
              f"{cfg['base_filters']} filters"
              f"{', int8' if cfg['quantized'] else ''}): built in "
              f"{time.time() - t0:.1f}s", flush=True)
    print("warm cache ready: cli pipeline skips these kernel builds",
          flush=True)


def cmd_view(args):
    """Open the interactive napari viewer over a session, the product form of
    the reference's main window: channel / labels / types / event layers
    with click modes for segmentation fixes, type changes and event marking
    (``viz/napari_viewer.py``). Edits persist to ``--session`` when the
    window closes."""
    import napari  # fail early with napari's own message if absent

    from tissue_image_processing_tpu_torch.viz.napari_viewer import TissueViewer

    images = None
    n = args.frames
    if args.movie:
        store = _load_movie(args.movie)
        n = store.num_frames
        data = np.asarray(store.data)          # (T, C, Z, Y, X)
        # display the z-projected movie like the reference's projected view
        images = data.max(axis=2) if data.ndim == 5 else data
    tissue = _open_session(args, n)
    viewer = TissueViewer(tissue, images=images, frame=args.frame,
                          type_name=args.type_name)
    viewer.mode = args.mode
    napari.run()
    _save_session(tissue, args)
    return viewer


def _embed_console(ns):
    """Live console over the session objects, the analog of the reference's
    embedded Jupyter console: IPython when present, code.interact
    otherwise."""
    banner = ("tissue_image_processing_tpu interactive session\n"
              f"objects: {', '.join(sorted(ns))}")
    try:
        from IPython import embed
        embed(banner1=banner, user_ns=ns, colors="neutral")
    except ImportError:
        import code
        code.interact(banner=banner, local=ns)


def build_parser():
    p = argparse.ArgumentParser(prog="tip", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, movie=True):
        if movie:
            sp.add_argument("movie", nargs="?", default=None)
        sp.add_argument("--session", default=None, help=".seg session path")
        sp.add_argument("--config", default=None,
                        help="PipelineConfig JSON; CLI flags override its values")
        sp.add_argument("--capacity", type=int, default=None)
        sp.add_argument("--frames", type=int, default=1)

    sp = sub.add_parser("segment", help="watershed segmentation")
    sp.add_argument("movie")
    sp.add_argument("--session", default=None)
    sp.add_argument("--config", default=None,
                    help="PipelineConfig JSON; CLI flags override its values")
    sp.add_argument("--capacity", type=int, default=None)
    sp.add_argument("--channel", type=int, default=0)
    sp.add_argument("--threshold", type=float, default=None)
    sp.add_argument("--std", type=float, default=None)
    sp.add_argument("--block-size", dest="block_size", type=int, default=None)
    sp.add_argument("--initial", type=int, default=1)
    sp.add_argument("--final", type=int, default=0)
    sp.set_defaults(fn=cmd_segment)

    sp = sub.add_parser("pipeline",
                        help="whole-movie proj->segment->track run")
    sp.add_argument("movie")
    sp.add_argument("--session", default=None)
    sp.add_argument("--config", default=None,
                    help="PipelineConfig JSON; CLI flags override its values")
    sp.add_argument("--capacity", type=int, default=None)
    sp.add_argument("--channel", type=int, default=0)
    sp.add_argument("--threshold", type=float, default=None)
    sp.add_argument("--std", type=float, default=None)
    sp.add_argument("--block-size", dest="block_size", type=int, default=None)
    sp.add_argument("--batch", type=int, default=2,
                    help="frames per stacked flood launch")
    sp.add_argument("--chunk", type=int, default=None,
                    help="frames per streamed T-chunk (movies larger than the "
                         "card's memory; default: auto — whole movie when it "
                         "fits, else ~2 GiB chunks with tracking-state carry)")
    # None defaults so _apply_config can resolve CLI > config > builtin
    sp.add_argument("--search-range", dest="search_range", type=float,
                    default=None)
    sp.add_argument("--memory", type=int, default=None)
    sp.add_argument("--events", action="store_true",
                    help="run event detection after tracking")
    sp.add_argument("--unet", action="store_true",
                    help="segment with the U-Net instead of watershed (the "
                         "reference's GUI U-Net workflow, as one streamed "
                         "run)")
    sp.add_argument("--weights", default=None,
                    help="Keras .h5 / saved U-Net weights (with --unet)")
    sp.add_argument("--quantize", action="store_true",
                    help="int8 U-Net inference (calibrates on the projected "
                         "first frame; 3x3 convs through the conv3x3_s8 "
                         "kernel)")
    sp.add_argument("--atoh-channel", dest="atoh_channel", type=int, default=0)
    sp.add_argument("--zo-channel", dest="zo_channel", type=int, default=1)
    sp.add_argument("--unet-batch", dest="unet_batch", type=int, default=8,
                    help="frames per U-Net forward and post-process flood")
    sp.add_argument("--unet-depth", dest="unet_depth", type=int, default=3,
                    help="down-blocks (3 = the reference's inference net, "
                         "2 = its training variant)")
    sp.add_argument("--unet-filters", dest="unet_filters", type=int,
                    default=128, help="first conv block's filter count")
    sp.add_argument("--cellpose", default=None, metavar="WEIGHTS",
                    help="segment with Cellpose v2: a cyto/cyto2/cyto3 "
                         "state_dict file, loaded strictly; its (cytoplasm, "
                         "nucleus) channels are --zo-channel, --atoh-channel")
    sp.add_argument("--cp-diameter", dest="cp_diameter", type=float,
                    default=None, help="cell diameter in pixels for "
                                       "--cellpose (default: the model's "
                                       "diam_mean)")
    sp.set_defaults(fn=cmd_pipeline)

    sp = sub.add_parser("unet", help="U-Net segmentation")
    sp.add_argument("movie")
    sp.add_argument("--session", default=None)
    sp.add_argument("--config", default=None,
                    help="PipelineConfig JSON; CLI flags override its values")
    sp.add_argument("--capacity", type=int, default=None)
    sp.add_argument("--weights", default=None)
    sp.add_argument("--atoh-channel", dest="atoh_channel", type=int, default=0)
    sp.add_argument("--zo-channel", dest="zo_channel", type=int, default=1)
    sp.add_argument("--initial", type=int, default=1)
    sp.add_argument("--final", type=int, default=0)
    sp.add_argument("--quantize", action="store_true",
                    help="int8 inference path (models/quant.py; output within "
                         "quantization noise)")
    sp.set_defaults(fn=cmd_unet)

    sp = sub.add_parser("types", help="classify cell types by marker channel")
    sp.add_argument("movie")
    sp.add_argument("--session", default=None)
    sp.add_argument("--config", default=None,
                    help="PipelineConfig JSON; CLI flags override its values")
    sp.add_argument("--capacity", type=int, default=None)
    sp.add_argument("--channel", type=int, default=0)
    sp.add_argument("--name", default="HC")
    sp.add_argument("--threshold", type=float, default=0.1)
    sp.add_argument("--percentage", type=float, default=90)
    sp.set_defaults(fn=cmd_types)

    sp = sub.add_parser("track", help="track cells over the movie")
    common(sp)
    sp.add_argument("--channel", type=int, default=0)
    sp.add_argument("--search-range", dest="search_range", type=float, default=None)
    sp.add_argument("--memory", type=int, default=None)
    sp.add_argument("--use-images", dest="use_images", action="store_true")
    sp.add_argument("--fix-types", dest="fix_types", action="store_true")
    sp.set_defaults(fn=cmd_track)

    sp = sub.add_parser("events", help="detect division/delamination/differentiation")
    common(sp, movie=False)
    sp.add_argument("--type-name", dest="type_name", default="")
    sp.set_defaults(fn=cmd_events)

    sp = sub.add_parser("export", help="export segmentation / events")
    common(sp, movie=False)
    sp.add_argument("outdir")
    sp.add_argument("--format", default="matlab",
                    choices=["matlab", "tiff", "tiff+types", "npy", "events"])
    sp.add_argument("--name", default=None)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("analyze", help="per-frame feature statistics")
    common(sp, movie=False)
    sp.add_argument("--feature", default="area")
    sp.add_argument("--out", default=None)
    sp.add_argument("--interactive", action="store_true",
                    help="drop into a live console (IPython if installed) "
                         "with the session objects after the analysis")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser("warmup",
                        help="build and load the kernel libraries (and the "
                             "predictor) a pipeline run on these flags uses")
    sp.add_argument("--config", default=None,
                    help="PipelineConfig JSON; CLI flags override its values")
    sp.add_argument("--frames", type=int, default=8,
                    help="chunk length T the pipeline will run with")
    sp.add_argument("--size", type=int, default=1024)
    sp.add_argument("--zdepth", type=int, default=30)
    sp.add_argument("--channels-n", dest="channels_n", type=int, default=2)
    sp.add_argument("--capacity", type=int, default=None)
    sp.add_argument("--channel", type=int, default=0)
    sp.add_argument("--threshold", type=float, default=None)
    sp.add_argument("--std", type=float, default=None)
    sp.add_argument("--block-size", dest="block_size", type=int, default=None)
    sp.add_argument("--batch", type=int, default=2)
    sp.add_argument("--search-range", dest="search_range", type=float,
                    default=None)
    sp.add_argument("--memory", type=int, default=None)
    sp.add_argument("--unet", action="store_true",
                    help="warm the U-Net path instead of the watershed one "
                         "(pair with pipeline --unet)")
    sp.add_argument("--quantize", action="store_true")
    sp.add_argument("--atoh-channel", dest="atoh_channel", type=int, default=0)
    sp.add_argument("--zo-channel", dest="zo_channel", type=int, default=1)
    sp.add_argument("--unet-depth", dest="unet_depth", type=int, default=3)
    sp.add_argument("--unet-filters", dest="unet_filters", type=int,
                    default=128)
    sp.add_argument("--unet-batch", dest="unet_batch", type=int, default=8)
    sp.set_defaults(fn=cmd_warmup)

    sp = sub.add_parser("view", help="interactive napari viewer over a session")
    common(sp)
    sp.add_argument("--frame", type=int, default=1)
    sp.add_argument("--mode", default="none",
                    choices=["none", "add_line", "remove_line", "change_type",
                             "mark_event"],
                    help="initial click mode")
    sp.add_argument("--type-name", default="HC",
                    help="cell type assigned by change_type clicks")
    sp.set_defaults(fn=cmd_view)
    return p


def _apply_config(args):
    """Resolve unset flags from the PipelineConfig (CLI > config file >
    builtin defaults) and attach the config as ``args.cfg``."""
    from tissue_image_processing_tpu_torch.config import PipelineConfig

    cfg = (PipelineConfig.from_json(args.config)
           if getattr(args, "config", None) else PipelineConfig())
    mapping = {
        "capacity": cfg.cells.max_cells,
        "threshold": cfg.segmentation.threshold,
        "std": cfg.segmentation.std,
        "block_size": cfg.segmentation.block_size,
        "search_range": cfg.tracking.search_range,
        "memory": cfg.tracking.memory,
    }
    # (the types subcommand's --threshold keeps its own 0.1 default: it is
    # the marker threshold, not the watershed one, so it never arrives as None)
    for attr, value in mapping.items():
        if hasattr(args, attr) and getattr(args, attr) is None:
            setattr(args, attr, value)
    args.cfg = cfg
    return args


def main(argv=None, device=None) -> int:
    """Run one subcommand on ``device`` (``None``: the CUDA card; raises
    before any file is read when there is none)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    args = _apply_config(args)
    args.device = dev
    # the kernel build cache, as the JAX CLI turns on its compilation cache
    from tissue_image_processing_tpu_torch.utils.runtime import (
        enable_compilation_cache)
    enable_compilation_cache()
    args.fn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
