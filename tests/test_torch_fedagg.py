"""One FedAgg round (FedEEC with SKR off) of the port against the JAX
trainer's; see ``tests/test_torch_fedeec.py`` for the setup."""
from test_torch_fedeec import check_round_parity, run_one_round


def test_fedagg_round_matches_jax():
    jt, tt, ds = run_one_round(use_skr=False)
    assert not tt.use_skr
    print(f"fedagg: params max|diff| after one round {check_round_parity(jt, tt, ds):.3e}")
