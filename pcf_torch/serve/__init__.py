from pcf_torch.serve.export import ServingModel, export_artifact

__all__ = ["ServingModel", "export_artifact"]
