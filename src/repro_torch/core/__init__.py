"""FedEEC core: topology, BSBODP losses, SKR, protocols and the trainer."""
