"""The model stack: configs' layers as pure functions over parameter trees."""
