"""Optional napari viewer and movie helper: the interactive half of the
GUI's re-scope as a CLI plus an optional viewer.

Port of ``tissue_image_processing_tpu/viz/napari_viewer.py``. The reference's
PyQt GUI mixes display, click dispatch and editing; here the editing lives in
``core/editing.py:SegmentationEditor``, so the viewer is a thin napari shell:

- :func:`build_layer_specs`: the layers of one frame (image, labels, types,
  events) as host numpy data, built without napari;
- :class:`TissueViewer`: a napari viewer over those layers with click modes
  that call ``SegmentationEditor`` and ``core/events.py:add_event`` (add
  line / remove line / change type / mark event), the GUI's click-dispatch
  state machine;
- :func:`scale_zchannel` / :func:`make_movie`: the napari movie helper.

napari is optional and imported only inside :func:`_require_napari` (and
:func:`napari_available`); the rest of the port never needs it. The session
computes on its own device; every layer handed to napari is a host array,
read back once per :meth:`TissueViewer.refresh`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tissue_image_processing_tpu_torch.core.cell_table import to_numpy

__all__ = ["napari_available", "build_layer_specs", "TissueViewer",
           "scale_zchannel", "make_movie"]


def napari_available() -> bool:
    try:
        import napari  # noqa: F401
        return True
    except ImportError:
        return False


def _require_napari():
    try:
        import napari
        return napari
    except ImportError as e:
        raise ImportError(
            "napari is not installed; `pip install napari[all]` to use the "
            "interactive viewer (the rest of the library does not need it)"
        ) from e


def build_layer_specs(tissue, frame: int, image: Optional[np.ndarray] = None,
                      type_name: str = "") -> List[Dict]:
    """Layer specs (kind, name, data, kwargs) for one frame: everything the
    viewer shows, as host arrays, produced without importing napari.

    - image layer (if ``image`` given, (C, Y, X));
    - labels layer from the frame's label map;
    - types overlay as a second labels layer (bitmask values);
    - events points layer (cy, cx per event touching this frame).
    """
    specs: List[Dict] = []
    if image is not None:
        img = to_numpy(image)
        if img.ndim == 2:
            img = img[None]
        for c in range(img.shape[0]):
            name = (tissue.channel_names[c]
                    if c < len(tissue.channel_names) else f"channel {c}")
            specs.append({"kind": "image", "name": name, "data": img[c],
                          "kwargs": {"blending": "additive"}})
    labels = tissue.get_labels(frame)
    if labels is not None:
        specs.append({"kind": "labels", "name": "segmentation",
                      "data": to_numpy(labels), "kwargs": {"opacity": 0.5}})
    types = tissue.get_cell_types(frame)
    if types is not None:
        specs.append({"kind": "labels", "name": "cell types",
                      "data": to_numpy(types).astype(np.int32),
                      "kwargs": {"opacity": 0.35}})
    ev = tissue.events
    if ev is not None and len(ev):
        in_frame = ev[(ev["start_frame"] <= frame) & (ev["end_frame"] >= frame)]
        if len(in_frame):
            pts = np.stack([in_frame["start_pos_y"].to_numpy(float),
                            in_frame["start_pos_x"].to_numpy(float)], axis=1)
            specs.append({
                "kind": "points", "name": "events", "data": pts,
                "kwargs": {"size": 12, "face_color": "red",
                           "features": {"type": in_frame["type"].tolist()}}})
    return specs


class TissueViewer:
    """napari shell over a ``Tissue`` session.

    Click modes (set ``viewer.mode``): "none", "add_line", "remove_line",
    "change_type", "mark_event"; each click calls the matching
    ``SegmentationEditor`` / ``add_event`` operation on the session (on its
    device) and refreshes the layers, the actions the reference's GUI
    dispatches on a click.
    """

    def __init__(self, tissue, images: Optional[np.ndarray] = None,
                 frame: int = 1, type_name: str = "HC"):
        napari = _require_napari()
        from tissue_image_processing_tpu_torch.core.editing import SegmentationEditor

        self.tissue = tissue
        self.images = images
        self.frame = frame
        self.type_name = type_name
        self.mode = "none"
        self.event_type = "division"
        self._pending_point = None
        self.editor = SegmentationEditor(tissue)
        self.viewer = napari.Viewer(title="tissue_image_processing_tpu")
        self._layer_names: List[str] = []
        self.refresh()
        self.viewer.mouse_drag_callbacks.append(self._on_click)

    # -- display --------------------------------------------------------------

    def refresh(self):
        for name in self._layer_names:
            if name in self.viewer.layers:
                self.viewer.layers.remove(name)
        self._layer_names = []
        img = None if self.images is None else self.images[self.frame - 1]
        for spec in build_layer_specs(self.tissue, self.frame, img,
                                      self.type_name):
            add = getattr(self.viewer, f"add_{spec['kind']}")
            add(spec["data"], name=spec["name"], **spec["kwargs"])
            self._layer_names.append(spec["name"])

    def set_frame(self, frame: int):
        self.frame = frame
        self._pending_point = None
        self.refresh()

    # -- click dispatch ---------------------------------------------------------

    def _on_click(self, viewer, event):
        if self.mode == "none" or event.type != "mouse_press":
            return
        y, x = (int(round(event.position[-2])), int(round(event.position[-1])))
        self.handle_click((x, y))

    def handle_click(self, point_xy):
        """Apply the active mode at an (x, y) click. Returns the editor rc."""
        rc = 0
        if self.mode == "add_line":
            if self._pending_point is None:
                self._pending_point = point_xy
                return 0
            # two-click line = a one-segment drag: initial (snapshots undo
            # state) AND final (runs the split + table refresh) in one call,
            # like the reference's press -> release pair
            rc = self.editor.add_segmentation_line(
                self.frame, self._pending_point, point_xy,
                initial=True, final=True)
            self._pending_point = None
        elif self.mode == "remove_line":
            rc = self.editor.remove_segmentation_line(self.frame, point_xy)
        elif self.mode == "change_type":
            rc = self.editor.change_cell_type(self.frame, point_xy,
                                              self.type_name)
        elif self.mode == "mark_event":
            from tissue_image_processing_tpu_torch.core.events import add_event
            add_event(self.tissue, self.event_type, self.frame, self.frame,
                      start_pos=point_xy, end_pos=point_xy)
        self.refresh()
        return rc

    def undo(self):
        rc = self.editor.undo_last_action(self.frame)
        self.refresh()
        return rc


# -- movie helper (reference napari_make_movie.py) ----------------------------

def scale_zchannel(viewer, new_zscale: float) -> int:
    """Apply a z scale to every 4-D (T, Z, Y, X) layer; returns how many
    layers were scaled (reference ``napari_make_movie.py:3-7``)."""
    n = 0
    for layer in viewer.layers:
        if len(np.shape(layer.data)) == 4:
            layer.scale = [1, new_zscale, 1, 1]
            n += 1
    return n


def make_movie(viewer, output_path: str, fps: int = 10):
    """Keyframe a fly-through over T and write the animation (reference
    ``napari_make_movie.py:9-19``; needs napari-animation)."""
    try:
        from napari_animation import Animation
    except ImportError as e:
        raise ImportError("napari-animation is not installed") from e
    viewer.dims.set_point(0, 0)
    viewer.dims.ndisplay = 3
    animation = Animation(viewer)
    animation.capture_keyframe()
    image = viewer.layers[0].data
    viewer.dims.set_point(0, image.shape[0])
    animation.capture_keyframe(steps=image.shape[0])
    animation.animate(output_path, fps=fps)
