"""Mid-training generative evaluation hook (port of
``ssdnerf_tpu/core/evaluation/eval_hooks.py``): every ``interval``
iterations ``evaluate_3d`` on a validation set, under the model's
``eval_mode`` (its ``test_cfg.override_cfg``), its metrics' summaries,
the results logged with a ``val/`` prefix.  In a data-parallel run every
rank holds the dataset and evaluates its share of the batches
(``evaluate_3d``'s ``group``), so each rank returns the same results and
no rank waits on the others for a whole evaluation."""
from ...runner.hooks import Hook


class GenerativeEvalHook3D(Hook):
    priority = 80
    greater_keys = ['test_psnr', 'test_ssim']
    less_keys = ['test_lpips', 'fid', 'kid']

    def __init__(self, dataset=None, interval=20000, feed_batch_size=32,
                 viz_step=32, metrics=None, viz_dir=None,
                 save_best_ckpt=False, data=None, **kwargs):
        self.dataset = dataset
        self.interval = interval
        self.feed_batch_size = feed_batch_size
        self.viz_step = viz_step
        self.metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics else [])
        self.viz_dir = viz_dir
        self.save_best_ckpt = save_best_ckpt
        self._best = {}

    def before_run(self, runner):
        for m in self.metrics:
            m.prepare()

    def after_train_iter(self, runner):
        if not self.every_n_iters(runner, self.interval) or \
                self.dataset is None:
            return
        from ...apis.test import evaluate_3d
        runner.model.eval_mode()
        runner.invalidate_step()
        try:
            log_vars = evaluate_3d(
                runner.model, self.dataset, batch_size=self.feed_batch_size,
                metrics=self.metrics, viz_dir=self.viz_dir,
                log_fn=runner.log_text, group=runner.group)
            for m in self.metrics:
                try:
                    m.summary()
                    log_vars.update(m.result_dict)
                    m.clear()
                except RuntimeError as e:
                    runner.log_text(f'metric {m.name} skipped: {e}')
        finally:
            runner.model.train_mode()
            runner.invalidate_step()
        runner.last_log_vars = dict(runner.last_log_vars, **{
            f'val/{k}': v for k, v in log_vars.items()})
        runner.log_text('Eval: ' + ', '.join(
            f'{k}={v:.4f}' for k, v in log_vars.items()))
        if self.save_best_ckpt:
            for k in self.greater_keys:
                if k in log_vars and log_vars[k] > self._best.get(k, -1e9):
                    self._best[k] = log_vars[k]
                    runner.save_checkpoint()
