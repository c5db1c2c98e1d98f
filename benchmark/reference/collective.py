"""The reference's own collectives for a data-parallel check: the group
interface the model code reads (``rank``, ``world_size``, ``share``,
``mean``, ``sum``), each tensor all-reduced on its own through
``torch.distributed``, independent of the port's bucketed ``Group``."""
import torch
import torch.distributed as dist


class Group:

    def __init__(self, rank, world_size, device):
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)

    def __deepcopy__(self, memo):
        return self

    @property
    def share(self):
        return 1.0 / self.world_size

    def sum(self, tensors):
        out = []
        for t in tensors:
            t = torch.as_tensor(t, device=self.device).detach().clone()
            dist.all_reduce(t)
            out.append(t)
        return out

    def mean(self, tensors):
        return [t / self.world_size for t in self.sum(tensors)]


class Unexchanged(Group):
    """A fault: the exchange between chips left out (each rank keeps its
    own values)."""

    def sum(self, tensors):
        return [torch.as_tensor(t, device=self.device).detach().clone()
                * self.world_size for t in tensors]
