from repro_torch.models.model import build_model, Model
