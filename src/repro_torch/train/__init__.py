from repro_torch.train.step import TrainState, make_train_step
