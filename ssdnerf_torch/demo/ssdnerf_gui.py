"""SSDNeRF viewer (port of the JAX package's ``demo/ssdnerf_gui.py``):

    python -m ssdnerf_torch.demo.ssdnerf_gui <config> <checkpoint>
        [--device cpu] [--fp16] [--cameras DIR [--camera-id N]] [--seed N]
        [--scene FILE] [--out-video FILE | --out-frames DIR]
        [--num-frames N] [--out-mesh FILE] [--mesh-resolution N]
        [--mesh-threshold X]

With dearpygui installed and a ``DISPLAY`` it opens the interactive orbit
viewer (generate, scene load / save, pose loading, mesh and video export);
otherwise it runs headless: it samples a scene (or loads ``--scene``),
renders an orbit video through imageio (or, with ``--out-frames``, its
frames as PNGs with the port's own writer, which needs no imageio) and
optionally a mesh.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import time

import numpy as np

from ..apis.inference import init_model
from ..core.gui import SSDNeRFViewer
from ..core.png import write_pngs


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='SSDNeRF viewer')
    parser.add_argument('config')
    parser.add_argument('checkpoint')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--fp16', action='store_true',
                        help='bf16 autocast sampling')
    parser.add_argument('--pose-path', default=None)
    parser.add_argument('--cameras', default=None,
                        help='SRN-layout trajectory dir (intrinsics.txt + '
                             'pose/*.txt) to set the camera from, e.g. '
                             'demo/camera_spiral')
    parser.add_argument('--camera-id', type=int, default=64,
                        help='which pose of --cameras to start from')
    parser.add_argument('--seed', type=int, default=0)
    # headless options
    parser.add_argument('--scene', default=None,
                        help='load a saved scene file instead of sampling')
    parser.add_argument('--out-video', default=None)
    parser.add_argument('--out-frames', default=None,
                        help='write the orbit as PNG frames into this dir '
                             'instead of a video')
    parser.add_argument('--out-mesh', default=None)
    parser.add_argument('--num-frames', type=int, default=60)
    parser.add_argument('--mesh-resolution', type=int, default=256)
    parser.add_argument('--mesh-threshold', type=float, default=10.0)
    return parser.parse_args(argv)


def run_headless(viewer, args):
    if args.scene:
        viewer.load_scene_file(args.scene)
        print(f'Loaded scene from {args.scene}')
    else:
        print('Sampling a scene...')
        viewer.generate(seed=args.seed)
    if args.out_frames:
        print(f'Rendering orbit frames -> {args.out_frames}')
        frames = viewer.render_orbit_frames(num_frames=args.num_frames)
        os.makedirs(args.out_frames, exist_ok=True)
        write_pngs([os.path.join(args.out_frames, f'{i:04d}.png')
                    for i in range(len(frames))], frames)
    else:
        out_video = args.out_video or 'viewer_orbit.mp4'
        print(f'Rendering orbit video -> {out_video}')
        viewer.render_orbit_video(out_video, num_frames=args.num_frames)
    if args.out_mesh:
        print(f'Extracting mesh -> {args.out_mesh}')
        viewer.export_mesh(args.out_mesh, resolution=args.mesh_resolution,
                           threshold=args.mesh_threshold)


def run_dearpygui(viewer, args):
    """The interactive viewer: dynamic resolution while dragging, generate
    with seed and sampler-step controls, scene save / load, pose loading,
    fovy / radius sliders, mesh and video export."""
    import dearpygui.dearpygui as dpg
    W, H = viewer.cam.W, viewer.cam.H
    state = dict(downscale=1, dragging=False)

    def _refresh(downscale=None):
        if viewer.code is None:
            return
        ds = downscale or state['downscale']
        t0 = time.perf_counter()
        img = viewer.render_view(downscale=ds)
        dt = time.perf_counter() - t0
        if ds > 1:  # upscale the preview to the texture size
            img = np.repeat(np.repeat(img, ds, axis=0), ds, axis=1)
        img = img[:H, :W]
        dpg.set_value('_texture', np.ascontiguousarray(
            img, dtype=np.float32))
        dpg.set_value('_log_time', f'render: {dt*1e3:.0f} ms (1/{ds})')

    def _generate():
        viewer.generate(seed=int(dpg.get_value('_seed')),
                        num_timesteps=int(dpg.get_value('_ddim_steps')))
        _refresh()

    def _drag(sender, app_data):
        viewer.cam.orbit(app_data[1], app_data[2])
        # coarse renders while interacting
        _refresh(downscale=int(dpg.get_value('_drag_downscale')))
        state['dragging'] = True

    def _release():
        if state['dragging']:
            state['dragging'] = False
            _refresh(downscale=1)

    dpg.create_context()
    with dpg.texture_registry():
        dpg.add_raw_texture(W, H, np.zeros((H, W, 3), np.float32),
                            format=dpg.mvFormat_Float_rgb, tag='_texture')
    with dpg.window(tag='_primary', width=W, height=H):
        dpg.add_image('_texture')
    with dpg.window(label='Control', width=300, pos=(W + 10, 0)):
        dpg.add_text('', tag='_log_time')
        with dpg.collapsing_header(label='Generate', default_open=True):
            dpg.add_input_int(label='seed', tag='_seed',
                              default_value=args.seed)
            dpg.add_slider_int(label='DDIM steps', tag='_ddim_steps',
                               default_value=int(viewer.model.test_cfg.get(
                                   'num_timesteps', 50)),
                               min_value=5, max_value=200)
            dpg.add_button(label='Generate', callback=_generate)
        with dpg.collapsing_header(label='Camera', default_open=True):
            dpg.add_slider_float(
                label='fovy', default_value=viewer.cam.fovy,
                min_value=20, max_value=90,
                callback=lambda s, a: (setattr(viewer.cam, 'fovy', a),
                                       _refresh()))
            dpg.add_slider_float(
                label='radius', default_value=viewer.cam.radius,
                min_value=0.5, max_value=5.0,
                callback=lambda s, a: (setattr(viewer.cam, 'radius', a),
                                       _refresh()))
            dpg.add_slider_int(label='drag 1/res', tag='_drag_downscale',
                               default_value=4, min_value=1, max_value=8)
            dpg.add_input_text(label='pose file', tag='_pose_path',
                               default_value=args.pose_path or '')
            dpg.add_button(
                label='Load pose',
                callback=lambda: (viewer.load_pose_file(
                    dpg.get_value('_pose_path')), _refresh()))
        with dpg.collapsing_header(label='Scene I/O', default_open=True):
            dpg.add_input_text(label='scene file', tag='_scene_path',
                               default_value=args.scene or 'scene.npz')
            dpg.add_button(
                label='Load scene',
                callback=lambda: (viewer.load_scene_file(
                    dpg.get_value('_scene_path')), _refresh()))
            dpg.add_button(
                label='Save scene',
                callback=lambda: viewer.save_scene_file(
                    dpg.get_value('_scene_path')))
        with dpg.collapsing_header(label='Export', default_open=True):
            dpg.add_input_int(label='mesh res', tag='_mesh_res',
                              default_value=args.mesh_resolution)
            dpg.add_input_float(label='mesh thresh', tag='_mesh_thresh',
                                default_value=args.mesh_threshold)
            dpg.add_button(
                label='Export mesh',
                callback=lambda: viewer.export_mesh(
                    'scene.stl', resolution=int(dpg.get_value('_mesh_res')),
                    threshold=float(dpg.get_value('_mesh_thresh'))))
            dpg.add_input_int(label='video frames', tag='_vid_frames',
                              default_value=args.num_frames)
            dpg.add_button(
                label='Export video',
                callback=lambda: viewer.render_orbit_video(
                    'scene.mp4',
                    num_frames=int(dpg.get_value('_vid_frames'))))

    with dpg.handler_registry():
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                   callback=_drag)
        dpg.add_mouse_release_handler(callback=lambda s, a: _release())
        dpg.add_mouse_wheel_handler(
            callback=lambda s, a: (viewer.cam.scale(a), _refresh()))
    dpg.create_viewport(title='ssdnerf', width=W + 320, height=H + 40)
    dpg.setup_dearpygui()
    if viewer.code is not None:
        _refresh()
    dpg.show_viewport()
    dpg.set_primary_window('_primary', True)
    dpg.start_dearpygui()
    dpg.destroy_context()


def main(argv=None):
    """Run the viewer; returns it (headless, after the exports)."""
    args = parse_args(argv)
    model = init_model(args.config, args.device, use_fp16=args.fp16,
                       checkpoint=args.checkpoint)
    viewer = SSDNeRFViewer(model)
    if args.cameras:
        viewer.load_camera_dir(args.cameras, camera_id=args.camera_id)
    try:
        import dearpygui.dearpygui  # noqa: F401
        has_gui = True
    except ImportError:
        has_gui = False
    if has_gui and os.environ.get('DISPLAY'):
        if args.scene:
            viewer.load_scene_file(args.scene)
        run_dearpygui(viewer, args)
    else:
        run_headless(viewer, args)
    return viewer


if __name__ == '__main__':
    main()
