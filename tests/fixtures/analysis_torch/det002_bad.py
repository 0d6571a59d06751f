"""DET002 violation, torch's half: its process-global generator."""
import torch


def draw(x):
    torch.manual_seed(0)
    torch.cuda.manual_seed_all(0)
    a = torch.rand(3)
    b = torch.randn(3, 4)
    c = torch.randint(0, 10, (3,))
    d = torch.randperm(5)
    e = torch.normal(0.0, 1.0, (2,))
    f = torch.bernoulli(x)
    g = torch.multinomial(x, 2)
    x.normal_()
    x.uniform_(0.0, 1.0)
    x.bernoulli_(0.5)
    x.random_(0, 5)
    x.exponential_()
    torch.nn.init.normal_(x)
    return a, b, c, d, e, f, g
