"""The general generators that turn a cell's parameters and a seed into
inputs and weights."""
