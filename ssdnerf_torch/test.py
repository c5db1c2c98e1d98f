"""Evaluation CLI of the port (the JAX package's root ``test.py``):

    python -m ssdnerf_torch.test <config> <checkpoint> [--device cpu]
        [--seed 0] [--viz-dir DIR] [--max-num-scenes N]
        [--cfg-options key=value ...]

Loads the config and a JAX-package checkpoint (``init_model``, lenient),
applies ``test_cfg.override_cfg`` (``eval_mode``), then for each entry of
the config's ``evaluation`` builds its dataset and metric, runs
``evaluate_3d`` and prints the log vars and the metric's summary as the
JAX CLI prints them.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse

from .apis.inference import init_model
from .apis.test import evaluate_3d
from .config import Config, parse_cfg_option
from .core.evaluation import build_metric
from .data.builder import build_dataset


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Test SSDNeRF (PyTorch)')
    parser.add_argument('config')
    parser.add_argument('checkpoint')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--viz-dir', default=None)
    parser.add_argument('--gpu-ids', nargs='+', type=int, default=None,
                        help='accepted for CLI parity; one device is used')
    parser.add_argument('--max-num-scenes', type=int, default=None)
    parser.add_argument('--cfg-options', nargs='+', default=[])
    return parser.parse_args(argv)


def main(argv=None):
    """Run the evaluations; returns a list of (log_vars, metrics) a
    ``evaluation`` entry."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(dict(parse_cfg_option(kv)
                                 for kv in args.cfg_options))
    model = init_model(cfg, device=args.device, checkpoint=args.checkpoint)
    model.eval_mode()
    results = []
    for ev in cfg.get('evaluation', []):
        ev = dict(ev)
        ev.pop('type', None)
        dataset = build_dataset(cfg.data[ev.pop('data')])
        metric_cfg = ev.pop('metrics', None)
        metrics = []
        if metric_cfg:
            metric = build_metric(metric_cfg, device=args.device)
            metric.prepare()
            metrics = [metric]
        log_vars = evaluate_3d(
            model, dataset, batch_size=ev.get('feed_batch_size', 32),
            metrics=metrics, viz_dir=args.viz_dir or ev.get('viz_dir'),
            max_num_scenes=args.max_num_scenes, seed=args.seed)
        print('==== evaluation results ====')
        for k, v in log_vars.items():
            print(f'  {k}: {v:.4f}')
        for m in metrics:
            try:
                m.summary()
                print(f'  {m.name}: {m.result_str}')
            except RuntimeError as e:
                print(f'  {m.name}: unavailable ({e})')
        results.append((log_vars, metrics))
    return results


if __name__ == '__main__':
    main()
