from repro_torch.optim.optimizers import Optimizer, adam, adamw, apply_updates
from repro_torch.optim.lbfgs import golden_section, line_search, scalar_lbfgs
