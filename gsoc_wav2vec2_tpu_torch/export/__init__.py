"""Serving artifacts of the port: `torch_export.py` (a `torch.export`
program whose kernels stay in the graph as `torch.library` operators),
`onnx_export.py` (a literal `.onnx` file, with its numpy evaluator
`onnx_numpy.py` and protobuf codec `onnx_proto.py`) and `savedmodel.py` (a
TF SavedModel that evaluates the ONNX builder's graph with TF ops).  The
modules are imported where used, so that loading an artifact loads no model
code."""
