"""Build progress and tracing (port of ``granne_tpu/utils``): ``progress.ProgressBar``
and the ``trace`` span registry and profiler hooks."""
