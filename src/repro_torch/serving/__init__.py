from repro_torch.serving.engine import GenerationResult, ServeEngine
