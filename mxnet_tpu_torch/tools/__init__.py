"""Command-line tools (reference: tools/): ``im2rec``,
``predict_exported``, ``caffe_converter``, ``convert_params``,
``parse_log`` and ``kill_mxnet``, each run as ``python -m
mxnet_tpu_torch.tools.<name>`` (``predict_exported`` also by path)."""
