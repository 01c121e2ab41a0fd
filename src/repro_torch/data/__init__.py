from repro_torch.data.pipeline import InputPipeline, SyntheticTokenSource, BatchSink
